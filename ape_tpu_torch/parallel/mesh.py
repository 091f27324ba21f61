"""Processes, the device mesh and sharding (counterpart of
``ape_tpu/parallel/mesh.py``): data parallelism and FSDP parameter sharding
the PyTorch way, one process a card.

JAX drives every device from one process through one ``Mesh`` of shape
(data, fsdp); XLA inserts the gradient all-reduce. Here each rank is a
process (``launch``, or torchrun) joined by ``torch.distributed`` (NCCL on
the card, gloo on the CPU); with ``fsdp == 1`` the model is wrapped in
``DistributedDataParallel``, with ``fsdp > 1`` FSDP2's ``fully_shard``
shards every repeated block and then the root over a 2-d ``DeviceMesh``
("data", "fsdp"): replicated over ``data``, sharded over ``fsdp`` (HSDP).
No ``MixedPrecisionPolicy`` is set: a step rounds as the one-process step
does.

Every used rank is data-parallel. A group's micro-batch of ``b`` rows is
cut into ``count = gcd(b, world)`` chunks; rank r takes chunk ``r // (world
// count)`` (``batch_chunk``), so where ``count < world`` the ranks of one
chunk hold the same rows, as JAX replicates its batch over ``fsdp``. JAX's
``local_batch_slice`` and ``shard_batch`` become the loaders' sampling of a
chunk (``data.build``; ``local_rows`` for a batch made whole) and
``engine.trainer.to_device``. The step is told its chunk (``batch_rows``, a
``RankRows``): its draws are made at the global batch and cut to its rows,
and a loss whose normaliser counts over the batch divides the all-reduced
count by ``count`` (detrex's ``num_boxes / world``), since DDP and FSDP2
average the gradients over the ranks: the mean is then the gradient of the
one-process step on the global batch.

FSDP2's gradient norm, state dicts and whole tensors come from PyTorch
(``clip_grad_norm_`` on DTensors, ``torch.distributed.checkpoint.state_dict``,
``DTensor.full_tensor``), whose DTensor collectives run under NCCL on the
card and gloo on the CPU. (gloo on CUDA tensors, where two ranks share one
card, segfaults in DTensor's gather in PyTorch 2.11, so in the full state
dicts; FSDP2's own all-gathers and reduce-scatters and the clip's norm run
there.)
"""

from __future__ import annotations

import contextlib
import datetime
import faulthandler
import logging
import math
import os
import socket
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ape_tpu_torch.utils.rows import WHOLE, Rows

logger = logging.getLogger("ape_tpu_torch")

# a rank that waits longer than this in a collective raises (NCCL, gloo)
TIMEOUT = datetime.timedelta(minutes=30)
# the other ranks wait this long for the main one's evaluation (``run_on_main``):
# COCO's 5000 validation images take over an hour at about 0.9 s an image
EVAL_TIMEOUT = datetime.timedelta(hours=24)

_MAIN_WAIT = None  # (default group, the gloo group ``run_on_main`` waits on)


def initialize_distributed(world_size: Optional[int] = None, device_type: str = "cuda",
                           backend: Optional[str] = None,
                           timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group (``torch.distributed.init_process_group``)
    from torchrun's environment, which ``launch`` sets too: ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` and ``WORLD_SIZE`` (or
    ``world_size``: the ranks that stay). A no-op for one process. On the
    card it takes ``cuda:LOCAL_RANK`` and NCCL, on the CPU gloo; ``backend``
    overrides (gloo on the card lets ranks share one). ``timeout``: a
    collective's (default ``TIMEOUT``). Returns True when a group of more
    than one process was joined."""
    world = int(os.environ.get("WORLD_SIZE", "1") if world_size is None else world_size)
    if world <= 1:
        return False
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                            timeout=timeout or TIMEOUT)
    logger.info(f"distributed: rank {rank}/{world}, {backend}, local rank {local_rank}")
    return True


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, or no process group."""
    return get_rank() == 0


def run_on_main(fn: Callable):
    """``fn()`` on the main rank while the others wait (evaluation during
    training, which outlasts a collective's ``TIMEOUT``): they wait in a
    barrier of a gloo group with ``EVAL_TIMEOUT``, made once a process
    group, which no NCCL watchdog times. Returns ``fn()`` on the main
    rank, None on the others; ``fn()`` without a process group."""
    global _MAIN_WAIT
    if not dist.is_initialized():
        return fn()
    if _MAIN_WAIT is None or _MAIN_WAIT[0] is not dist.group.WORLD:
        _MAIN_WAIT = (dist.group.WORLD, dist.new_group(backend="gloo", timeout=EVAL_TIMEOUT))
    out = fn() if is_main_process() else None
    dist.barrier(group=_MAIN_WAIT[1])
    return out


def data_axis(batch_sizes: Sequence[int], world: int, fsdp: int = 1) -> Tuple[int, int]:
    """JAX's mesh arithmetic (``tools/train_net.py``): (data, fsdp) with
    ``fsdp = gcd(fsdp, world)`` and ``data`` the gcd of every group's
    micro-batch and ``world // fsdp``. The ranks past ``data * fsdp`` are
    those whose devices JAX would leave idle."""
    fsdp = math.gcd(max(1, int(fsdp)), world)
    data = world // fsdp
    for b in batch_sizes:
        data = math.gcd(int(b), data)
    return max(data, 1), fsdp


def batch_chunk(batch: int) -> Tuple[int, int]:
    """(index, count): the chunk of a micro-batch of ``batch`` rows that this
    rank takes, of ``count = gcd(batch, world)`` equal chunks."""
    world = get_world_size()
    count = math.gcd(int(batch), world)
    return get_rank() // (world // count), count


def local_rows(batch, index: int, count: int, iter_size: int = 1):
    """The rows of chunk ``index`` of ``count`` in every micro-batch of a
    host batch (NumPy arrays or lists, nested in dicts) of ``iter_size``
    micro-batches: what the rank of that chunk loads."""
    if isinstance(batch, dict):
        return {k: local_rows(v, index, count, iter_size) for k, v in batch.items()}
    if not hasattr(batch, "__len__") or isinstance(batch, str):
        return batch
    micro = len(batch) // iter_size
    per = micro // count
    rows = [i * micro + index * per + j for i in range(iter_size) for j in range(per)]
    if isinstance(batch, list):
        return [batch[r] for r in rows]
    return batch[rows]


def make_mesh(n_devices: Optional[int] = None, fsdp: int = 1, device_type: str = "cuda"):
    """The ("data", "fsdp") ``DeviceMesh`` over the process group's ranks
    (``n_devices``: its size, default the world's); None without a process
    group (one process)."""
    if not dist.is_initialized():
        return None
    n = get_world_size() if n_devices is None else n_devices
    if n % fsdp:
        raise ValueError(f"{n} ranks do not split into fsdp groups of {fsdp}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n // fsdp, fsdp), mesh_dim_names=("data", "fsdp"))


def _block_classes():
    """The repeated blocks ``param_sharding`` shards one by one."""
    from ape_tpu_torch.layers.fuse import VisionLanguageFusion
    from ape_tpu_torch.modeling.ape_deta.transformer import DecoderLayer, EncoderLayer
    from ape_tpu_torch.modeling.backbone.eva_vit import Block

    return (Block, EncoderLayer, DecoderLayer, VisionLanguageFusion)


def param_sharding(mesh, model: torch.nn.Module) -> torch.nn.Module:
    """FSDP2 over ``mesh``: ``fully_shard`` on every ViT block, encoder and
    decoder layer and fusion layer, then on the root (the rest), as
    ``ModuleWrapPolicy`` wraps the reference's blocks. The parameters become
    DTensors sharded on dim 0 over "fsdp" and replicated over "data"; build
    the optimizer after this call."""
    from torch.distributed.fsdp import fully_shard

    blocks = _block_classes()
    for m in list(model.modules()):
        if m is not model and isinstance(m, blocks):
            fully_shard(m, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def wrap_model(model: torch.nn.Module, mesh, fsdp: int) -> torch.nn.Module:
    """The model for the step: itself for one process, FSDP2
    (``param_sharding``) for ``fsdp > 1``, else DistributedDataParallel.
    DDP takes ``find_unused_parameters=True``: a group without masks, or a
    model whose heads the criterion does not read, leaves parameters
    without a gradient, which DDP otherwise waits for and fails on at the
    next step. Its buffers are constants and not broadcast."""
    if mesh is None:
        return model
    if fsdp > 1:
        return param_sharding(mesh, model)
    from torch.nn.parallel import DistributedDataParallel

    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        find_unused_parameters=True, broadcast_buffers=False)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module whose parameter names are the one-process model's."""
    return getattr(model, "module", model)


def is_sharded(model: torch.nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


@contextlib.contextmanager
def no_gradient_sync(model: torch.nn.Module, enabled: bool = True):
    """Accumulate this backward's gradients without reducing them across
    ranks: DDP's ``no_sync``, FSDP2's ``set_requires_gradient_sync(False)``."""
    if not enabled or not dist.is_initialized():
        yield
    elif is_sharded(model):
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)
    elif hasattr(model, "no_sync"):
        with model.no_sync():
            yield
    else:
        yield


class RankRows(Rows):
    """A rank's chunk of the step's global batch (``utils.rows``): its
    counts summed and its class masks OR-ed over the ranks, each chunk
    counted once (the ranks that share a chunk divide it out)."""

    def count_sum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x)
        world = dist.get_world_size()
        return x * self.count / world if self.count != world else x

    def any(self, mask: torch.Tensor) -> torch.Tensor:
        m = mask.to(torch.uint8)
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        return m.bool()


def batch_rows(batch: int) -> Rows:
    """The step's ``Rows`` for a micro-batch of ``batch`` rows: this rank's
    chunk (``batch_chunk``) in a process group, else the whole batch."""
    if not dist.is_initialized():
        return WHOLE
    return RankRows(*batch_chunk(batch))


def mean_over_ranks(tensors: Sequence[torch.Tensor]) -> list:
    """Scalars averaged over the ranks in one all-reduce: the step's loss
    terms as the one-process step reports them (each rank's terms carry
    its normaliser's 1 / chunks)."""
    if not dist.is_initialized() or not tensors:
        return list(tensors)
    flat = torch.stack([t.detach().float().reshape(()) for t in tensors])
    dist.all_reduce(flat)
    return list((flat / dist.get_world_size()).unbind())


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order ([obj] for one process)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(local_rank: int, main_fn: Callable, world: int, machine_rank: int,
            per_machine: int, addr: str, port: int, threads: int, args: tuple) -> None:
    faulthandler.enable()  # a rank that crashes prints its stack
    if threads:
        torch.set_num_threads(threads)
    os.environ.update(RANK=str(machine_rank * per_machine + local_rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(per_machine),
                      MASTER_ADDR=addr, MASTER_PORT=str(port))
    main_fn(*args)


def launch(main_fn: Callable, num_gpus_per_machine: int, num_machines: int = 1,
           machine_rank: int = 0, dist_url: str = "auto", args: tuple = (),
           device_type: str = "cuda", backend: Optional[str] = None) -> None:
    """detectron2's ``launch``: ``main_fn(*args)`` in one process a card
    (``torch.multiprocessing``, start method ``spawn``), each with
    torchrun's environment set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), which ``initialize_distributed``
    reads. ``dist_url``: ``tcp://host:port``, or "auto" for a free port on
    localhost (one machine only). On the card NCCL takes one card a rank,
    so more ranks than cards raise; with ``backend="gloo"`` ranks may share
    one. ``device_type="cpu"`` runs the ranks on the CPU. One process runs
    ``main_fn`` itself. A rank that raises ends the others and re-raises."""
    world = num_gpus_per_machine * num_machines
    if device_type == "cuda" and (backend or "nccl") == "nccl":
        have = torch.cuda.device_count()
        if num_gpus_per_machine > have:
            raise ValueError(f"--num-gpus {num_gpus_per_machine}: this machine has {have} CUDA "
                             "device(s), and NCCL takes one a rank")
    if world <= 1:
        main_fn(*args)
        return
    if dist_url == "auto":
        if num_machines > 1:
            raise ValueError("dist_url='auto' is for one machine; pass tcp://host:port")
        addr, port = "localhost", free_port()
    else:
        host_port = dist_url.split("://", 1)[-1]
        addr, port = host_port.rsplit(":", 1)
    import torch.multiprocessing as mp

    # CPU ranks share this process's intra-op threads
    threads = max(1, torch.get_num_threads() // num_gpus_per_machine) if device_type == "cpu" else 0
    mp.start_processes(_worker, nprocs=num_gpus_per_machine, join=True, start_method="spawn",
                       args=(main_fn, world, machine_rank, num_gpus_per_machine, addr, int(port),
                             threads, tuple(args)))
