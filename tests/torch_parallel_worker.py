"""The ranks of ``tests/test_torch_parallel.py``, spawned by the port's
``parallel.mesh.launch`` on the CPU under gloo, in interpreters that refuse
jax, flax and the JAX package:

    python -m tests.torch_parallel_worker <job.pt>

A job (a dict saved with ``torch.save``) holds ``world`` and ``kind``:

  * "steps": one process group for a list of ``scenarios``, each a train
    step of the tiny model (``configs/tests/ape_deta_tiny.py``, the job's
    ``weights``) on this rank's rows of the job's global ``batch``, wrapped
    in DDP ("ddp") or FSDP2 on a ("data", "fsdp") mesh ("fsdp"), with
    ``iter_size`` and, under ``nan_rank``, a NaN in that rank's first pixel;
    optionally from a checkpoint (``load``), saving one after the step
    (``save``), and a second step on ``then``. Rank 0 saves the loss terms,
    the clipped gradients (gathered), the norm, the parameters and the
    optimizer's state after each step; each rank that raises
    ``FloatingPointError`` saves a marker instead.
  * "train_net": ``train_net``'s arguments ``argv``; the ranks run
    ``do_train`` as ``train_ranks`` does, then rank 0 saves the gathered
    state (model, optimizer, loaders, generator) and every rank the dataset
    ids of its steps. With ``eval_sleep`` the config gets a test set and
    ``run_eval`` becomes a wait of that many seconds (longer than the job's
    ``timeout``, the process group's): every rank records what its
    evaluations returned.
"""

import sys


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "ape_tpu"):
            raise ImportError("refused: " + name)


sys.meta_path.insert(0, _Refuse())

import datetime  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from ape_tpu_torch.parallel import mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs" / "tests" / "ape_deta_tiny.py")
TIMEOUT = datetime.timedelta(seconds=120)  # a rank left waiting in a collective fails


def _tensors(batch):
    if isinstance(batch, dict):
        return {k: _tensors(v) for k, v in batch.items()}
    t = torch.from_numpy(batch)
    return t.long() if t.dtype == torch.int32 else t


def _whole(t):
    """A tensor whole (FSDP2's DTensor gathered) on the CPU."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().cpu()


def _result(model, module, optimizer, metrics, rows):
    from ape_tpu_torch.checkpoint.checkpointer import model_state, optimizer_state

    grads = {n: _whole(p.grad) for n, p in module.named_parameters() if p.grad is not None}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": model_state(model), "optimizer": optimizer_state(model, optimizer),
            "rows": rows}


def _step(job, sc, rank, world):
    """One scenario: ``load`` a checkpoint first (its state saved again,
    gathered, to ``loaded``), a step on ``batch``, ``save`` a checkpoint,
    then a step on ``then`` (saved to ``out2``)."""
    from ape_tpu_torch.checkpoint.checkpointer import (
        load_optimizer_state,
        model_state,
        optimizer_state,
    )
    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.model_zoo import build_criterion, build_model

    cfg = LazyConfig.load(TINY)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(job["weights"]))
    ckpt = torch.load(sc["load"], weights_only=False) if "load" in sc else None
    if ckpt is not None:
        model.load_state_dict(ckpt["model"])
    fsdp = sc.get("fsdp", 1)
    if sc["wrap"] == "ddp":
        model = mesh.wrap_model(model, mesh.make_mesh(world, 1, "cpu"), 1)
    else:
        model = mesh.param_sharding(mesh.make_mesh(world, fsdp, "cpu"), model)
    module = mesh.unwrap(model)
    opt_cfg = dict(cfg.optimizer)
    opt_cfg.pop("grad_clip")
    optimizer, scheduler = build_optimizer(module, **opt_cfg)
    if ckpt is not None:
        load_optimizer_state(model, optimizer, ckpt["optimizer"])
        state = {"model": model_state(model), "optimizer": optimizer_state(model, optimizer)}
        if rank == 0:
            torch.save(state, sc["loaded"])
    iter_size = sc.get("iter_size", 1)
    rows = mesh.batch_rows(len(torch.load(job["batch"], weights_only=False)["images"]) // iter_size)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler, iter_size=iter_size,
                           rows=rows)
    for key, out, seed in (("batch", "out", 0), ("then", "out2", 1)):
        path = sc.get(key, job["batch"] if key == "batch" else None)
        if path is None or out not in sc:
            continue
        batch = torch.load(path, weights_only=False)
        local = _tensors(mesh.local_rows(batch, rows.index, rows.count, iter_size))
        if sc.get("nan_rank") == rank:
            local["images"][0, 0, 0, 0] = float("nan")
        try:
            metrics = step(local, torch.Generator().manual_seed(seed))
        except FloatingPointError as e:
            Path(f"{sc[out]}.rank{rank}").write_text(str(e))
            return
        result = _result(model, module, optimizer, metrics, len(local["images"]))
        if rank == 0:
            torch.save(result, sc[out])
        if "save" in sc and key == "batch" and rank == 0:
            torch.save({"model": result["params"], "optimizer": result["optimizer"]}, sc["save"])


def _train_net(job, rank, world):
    from ape_tpu_torch.checkpoint.checkpointer import model_state, optimizer_state
    from ape_tpu_torch.data.build import loader_state
    from ape_tpu_torch.tools import train_net

    args, cfg, device = train_net._setup(job["argv"], "cpu")
    micro = [int(g.get("batch_size", 1)) for g in train_net._train_groups(cfg)]
    data, fsdp = mesh.data_axis(micro, world, int(cfg.train.get("fsdp", 1)))
    evaluated = []
    if "eval_sleep" in job:
        def slow_eval(cfg, model, device):
            time.sleep(job["eval_sleep"])
            return {"slow": {"AP": 1.0}}

        def recorded(cfg, model, device):
            out = eval_on_main(cfg, model, device)
            evaluated.append(out)
            return out

        cfg.dataloader.tests = [dict(dataset_name="slow")]
        # the main rank's TensorBoard writer imports TensorFlow, seconds that
        # the other would wait in the first step: every rank pays it first
        importlib.import_module("torch.utils.tensorboard")
        train_net.run_eval, eval_on_main, train_net.eval_on_main = (
            slow_eval, train_net.eval_on_main, recorded)
    timeout = datetime.timedelta(seconds=job["timeout"]) if "timeout" in job else TIMEOUT
    mesh.initialize_distributed(world_size=data * fsdp, device_type="cpu", timeout=timeout)
    try:
        summary = train_net.do_train(args, cfg, device, fsdp=fsdp)
        model, trainer = summary["model"], summary["trainer"]
        state = {"model": model_state(model),
                 "optimizer": optimizer_state(model, summary["optimizer"]),
                 "loaders": [loader_state(ld, *chunk)
                             for ld, chunk in zip(trainer.loaders, summary["batch_chunks"])],
                 "generator": trainer.generator.get_state(), "start_iter": summary["start_iter"]}
        ids = trainer.storage.histories().get("dataset_id")
        torch.save(list(ids._window) if ids is not None else [], f"{job['out']}.ids{rank}")
        torch.save(evaluated, f"{job['out']}.evaluated{rank}")
        if rank == 0:
            torch.save(state, job["out"])
    finally:
        torch.distributed.destroy_process_group()


def _rank(job):
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if job["kind"] == "train_net":
        _train_net(job, rank, world)
        return
    mesh.initialize_distributed(device_type="cpu", timeout=TIMEOUT)
    try:
        for sc in job["scenarios"]:
            _step(job, sc, rank, world)
    finally:
        torch.distributed.destroy_process_group()


def main():
    job = torch.load(sys.argv[1], weights_only=False)
    torch.set_num_threads(job.get("threads", 2))
    mesh.launch(_rank, job["world"], device_type="cpu", args=(job,))
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "ape_tpu")]
    assert not leaked, leaked


if __name__ == "__main__":
    main()
