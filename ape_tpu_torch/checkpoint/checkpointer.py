"""Checkpoints of a training run (counterpart of
``ape_tpu/checkpoint/checkpointer.py``, over ``torch.save`` where JAX's uses
orbax): ``Checkpointer`` keeps the newest ``keep`` files of a run, names the
newest in ``last_checkpoint`` (detectron2's tag file) and resumes or loads;
``PeriodicCheckpointer`` saves every ``period`` iterations and at the last.

A checkpoint is a dict whose ``"model"`` holds the model's state_dict under
the reference's names on the CPU, so a ``model_final.pth`` is what JAX's
``load_params_tolerant`` and the port's ``load_checkpoint_tolerant`` read.
Beside it the trainer stores the rest of the run's state: the optimizer
(AdamW's moments), the scheduler, the EMA, the iteration, the step's
``torch.Generator``, the loaders' positions and the text router's bank.
Periodic files are ``model_{iteration:07d}.pth``; the one at ``max_iter``
is ``model_final.pth``.

Across ranks (``parallel.mesh``) every rank gathers the state (collective
under FSDP2) and the main one writes it: whole tensors under the one-process
model's names, without DDP's ``module.`` prefix, the optimizer's state keyed
by parameter name (``model_state``, ``optimizer_state``: the full state
dicts of ``torch.distributed.checkpoint.state_dict``; ``ema_state``). One
process writes the same format. Any world size loads it: the model's
weights into the one-process model before DDP copies or FSDP2 shards it,
the optimizer's by ``load_optimizer_state`` and the EMA's by ``load_ema``;
each rank reads the file and keeps its shards, as JAX's orbax restores to
any mesh.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ape_tpu_torch.parallel.mesh import is_main_process

logger = logging.getLogger("ape_tpu_torch")


def _full(cpu_offload: bool = True):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, cpu_offload=cpu_offload)


def model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's whole state_dict on the CPU under the one-process names
    (DDP's or FSDP2's model; on the main rank, {} on the others: call it
    on every rank)."""
    from torch.distributed.checkpoint.state_dict import get_model_state_dict

    return get_model_state_dict(model, options=_full())


def optimizer_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Dict:
    """The optimizer's whole state_dict on the CPU, keyed by parameter name
    (on the main rank, {} on the others: call it on every rank). Call it
    after a step: on an optimizer without state PyTorch takes a step at
    learning rate 0 to make one, which counts in AdamW's bias correction."""
    from torch.distributed.checkpoint.state_dict import get_optimizer_state_dict

    return get_optimizer_state_dict(model, optimizer, options=_full())


def load_optimizer_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         state: Dict) -> None:
    """Load ``optimizer_state``'s dict; under FSDP2 each rank keeps its
    shard of every moment."""
    from torch.distributed.checkpoint.state_dict import set_optimizer_state_dict

    set_optimizer_state_dict(model, optimizer, state, options=_full(cpu_offload=False))


def ema_state(ema: Optional[List[torch.Tensor]]) -> Optional[List[torch.Tensor]]:
    """The EMA's tensors whole on the CPU (FSDP2's gathered by
    ``DTensor.full_tensor``: call it on every rank)."""
    if ema is None:
        return None
    return [(e.full_tensor() if hasattr(e, "full_tensor") else e).detach().cpu() for e in ema]


def load_ema(ema: List[torch.Tensor], saved: List[torch.Tensor]) -> None:
    """Copy ``ema_state``'s tensors into the EMA, each rank its shards."""
    from torch.distributed.tensor import distribute_tensor

    with torch.no_grad():
        for e, v in zip(ema, saved):
            v = v.to(e.device)
            if hasattr(e, "device_mesh"):
                v = distribute_tensor(v, e.device_mesh, e.placements, src_data_rank=None)
            e.copy_(v)


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class Checkpointer:
    def __init__(self, save_dir: str, keep: int = 2):
        self.save_dir = save_dir
        self.keep = keep
        os.makedirs(save_dir, exist_ok=True)
        self._index = os.path.join(save_dir, "checkpoints.json")

    def _saved(self) -> List[Tuple[int, str]]:
        """[(iteration, file name)] oldest first."""
        if not os.path.exists(self._index):
            return []
        with open(self._index) as f:
            return [tuple(e) for e in json.load(f)]

    def save(self, step: int, state: Dict[str, Any], name: Optional[str] = None) -> str:
        """Write ``state`` (tensors to the CPU) with ``iteration=step`` as
        ``name`` (default ``model_{step:07d}.pth``), tag it as the newest and
        delete the files older than the newest ``keep``. Returns its path.
        Only the main process writes."""
        name = name or f"model_{step:07d}.pth"
        path = os.path.join(self.save_dir, name)
        if not is_main_process():
            return path
        torch.save(_to_cpu({**state, "iteration": step}), path + ".tmp")
        os.replace(path + ".tmp", path)
        saved = [e for e in self._saved() if e[1] != name] + [(step, name)]
        for _, old in saved[:-self.keep]:
            if os.path.exists(os.path.join(self.save_dir, old)):
                os.remove(os.path.join(self.save_dir, old))
        with open(self._index, "w") as f:
            json.dump(saved[-self.keep:], f)
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(name)
        return path

    def kept(self) -> List[str]:
        """The checkpoint files on disk, oldest first."""
        return [n for _, n in self._saved()]

    def latest_step(self) -> Optional[int]:
        saved = self._saved()
        return saved[-1][0] if saved else None

    def load(self) -> Optional[Dict[str, Any]]:
        """The newest checkpoint's dict, None when there is none."""
        saved = self._saved()
        if not saved:
            return None
        return torch.load(os.path.join(self.save_dir, saved[-1][1]), map_location="cpu",
                          weights_only=False)

    def resume_or_load(self, resume: bool = True):
        """detectron2's resume_or_load: resuming with a checkpoint in the
        directory returns (its dict, its iteration); otherwise (None, 0), and
        the caller loads ``train.init_checkpoint``'s weights alone
        (``load_checkpoint_tolerant``)."""
        if resume and self.latest_step() is not None:
            state = self.load()
            logger.info(f"resumed from iteration {state['iteration']}")
            return state, int(state["iteration"])
        return None, 0


class PeriodicCheckpointer:
    def __init__(self, checkpointer: Checkpointer, period: int = 5000, max_iter: int = None):
        self.checkpointer = checkpointer
        self.period = period
        self.max_iter = max_iter

    def step(self, iteration: int, state_fn) -> Optional[str]:
        """After iteration ``iteration`` (0-based): save ``state_fn()`` every
        ``period`` iterations and at ``max_iter`` (as ``model_final.pth``).
        Returns the path written, if any. Call it on every rank: gathering a
        sharded state is collective."""
        done = iteration + 1
        if self.max_iter and done >= self.max_iter:
            return self.checkpointer.save(done, state_fn(), "model_final.pth")
        if self.period and done % self.period == 0:
            return self.checkpointer.save(done, state_fn())
        return None
