"""Training loop orchestration (counterpart of ``ape_tpu/engine/trainer.py``):
the multi-loader choice per step, per-dataset image and object counters,
the non-finite-loss guard, the writers every ``log_period``, periodic
checkpoints and evaluation, and a profile window (``torch.profiler`` where
JAX's uses ``jax.profiler``); and ``inference_on_dataset``, the eval loop
with its stage times.

A step: the next batch of the chosen loader (NumPy on the host), the text
router's features, the batch to the model's device (pinned host memory and
non-blocking copies on the card), then the step function of that dataset
(``engine.train_step.make_train_step``'s, keyed by criterion and prompt
type) with the run's ``torch.Generator``. ``sync_debug`` counts each step's
host syncs (``torch.cuda.set_sync_debug_mode``) into the ``host_syncs``
scalar.
"""

from __future__ import annotations

import logging
import time
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ape_tpu_torch.utils.events import (
    CommonMetricPrinter,
    EventStorage,
    JSONWriter,
    TensorboardWriter,
)

logger = logging.getLogger("ape_tpu_torch")


def to_device(batch, device: torch.device):
    """NumPy arrays (nested in dicts) as tensors on ``device``: through
    pinned memory with non-blocking copies to a CUDA device."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Trainer:
    def __init__(
        self,
        step_fn_by_dataset: Callable,  # ds_id -> step(batch, generator) -> metrics
        loaders: Sequence,  # one TrainLoader a dataset group
        device: torch.device,
        generator: Optional[torch.Generator] = None,
        dataset_sampler=None,  # MultiDatasetSampler, or None for one loader
        text_fn: Optional[Callable] = None,  # batch -> batch with text features
        max_iter: int = 10000,
        log_period: int = 20,
        output_dir: str = "./output",
        checkpointer=None,  # PeriodicCheckpointer
        state_fn: Optional[Callable] = None,  # () -> the run's state for a checkpoint
        eval_fn: Optional[Callable] = None,  # () -> dict of results
        eval_period: int = 0,
        lr_fn: Optional[Callable] = None,  # step -> lr (for logging)
        profile_dir: Optional[str] = None,  # torch.profiler trace output dir
        profile_start: int = 10,  # first profiled iteration
        profile_iters: int = 5,  # iterations in the trace window
        sync_debug: bool = False,
    ):
        self.step_fn_by_dataset = step_fn_by_dataset
        self.loaders = list(loaders)
        self.iters = [iter(ld) for ld in self.loaders]
        self.device = torch.device(device)
        self.generator = generator
        self.dataset_sampler = dataset_sampler
        self.text_fn = text_fn
        self.max_iter = max_iter
        self.log_period = log_period
        self.checkpointer = checkpointer
        self.state_fn = state_fn
        self.eval_fn = eval_fn
        self.eval_period = eval_period
        self.lr_fn = lr_fn
        self.profile_dir = profile_dir
        self.profile_start = profile_start
        self.profile_iters = profile_iters
        self.sync_debug = sync_debug
        self.storage = EventStorage()
        self.writers = [
            CommonMetricPrinter(max_iter, log_period),
            JSONWriter(f"{output_dir}/metrics.json", log_period),
            TensorboardWriter(f"{output_dir}/tb", log_period),
        ]
        self.checkpoint_seconds: list = []  # (path, seconds) of each save

    def _next_batch(self) -> Dict:
        ds_id = 0
        if self.dataset_sampler is not None and len(self.loaders) > 1:
            ds_id = self.dataset_sampler.next_dataset()
        batch = next(self.iters[ds_id])
        batch["dataset_id"] = ds_id
        return batch

    def run_step(self):
        start = time.perf_counter()
        batch = self._next_batch()
        if self.text_fn is not None:
            batch = self.text_fn(batch)
        data_time = time.perf_counter() - start

        ds_id = batch.pop("dataset_id", 0)
        pasted = batch.pop("copypaste", 0)
        batch.pop("phrases", None)
        for k in ("image_id", "height", "width"):
            batch.pop(k, None)
        n_img = batch["images"].shape[0]
        n_obj = int(np.asarray(batch["targets"]["valid"]).sum()) if "targets" in batch else 0
        step = self.step_fn_by_dataset(ds_id)
        if self.sync_debug and self.device.type == "cuda":
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    metrics = step(to_device(batch, self.device), self.generator)
                    total = float(metrics["total_loss"])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            self.storage.put_scalar("host_syncs", sum(
                "synchronizing CUDA operation" in str(w.message) for w in caught))
        else:
            metrics = step(to_device(batch, self.device), self.generator)
            total = float(metrics["total_loss"])
        if not np.isfinite(total):
            raise FloatingPointError(
                f"Loss became non-finite at iteration {self.storage.iter}: {metrics}")
        self.storage.put_scalar("total_loss", total)
        self.storage.put_scalar("data_time", data_time)
        self.storage.put_scalar("dataset_id", ds_id)
        self.storage.put_scalar("count_copypaste", pasted)
        self.storage.put_scalar(f"count_image/{ds_id}", n_img)
        self.storage.put_scalar(f"count_object/{ds_id}", n_obj)
        for k, v in metrics.items():
            if k != "total_loss" and v.dim() == 0:
                self.storage.put_scalar(k, float(v))

    def train(self, start_iter: int = 0):
        logger.info(f"Starting training from iteration {start_iter} to {self.max_iter}")
        self.storage.iter = start_iter
        t0 = time.perf_counter()
        prof = None
        try:
            for it in range(start_iter, self.max_iter):
                if self.profile_dir:
                    if it == self.profile_start:
                        logger.info(f"profiler: tracing to {self.profile_dir}")
                        prof = torch.profiler.profile(
                            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                                self.profile_dir))
                        prof.start()
                    elif prof is not None and it == self.profile_start + self.profile_iters:
                        prof.stop()
                        prof = None
                self.run_step()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.storage.put_scalar("time", time.perf_counter() - t0)
                if self.lr_fn is not None:
                    self.storage.put_scalar("lr", float(self.lr_fn(it)))
                if (it + 1) % self.log_period == 0:
                    for w in self.writers:
                        w.write(self.storage)
                if self.checkpointer is not None:
                    t1 = time.perf_counter()
                    path = self.checkpointer.step(it, self.state_fn)
                    if path:
                        self.checkpoint_seconds.append((path, time.perf_counter() - t1))
                if (self.eval_fn is not None and self.eval_period > 0
                        and (it + 1) % self.eval_period == 0 and (it + 1) != self.max_iter):
                    logger.info(f"running evaluation at iteration {it + 1}")
                    for name, res in (self.eval_fn() or {}).items():
                        logger.info(f"[eval @ {it + 1}] {name}: {res}")
                self.storage.step()
                t0 = time.perf_counter()  # eval and checkpoint time aren't step time
        finally:
            if prof is not None:
                prof.stop()
            for ld in self.loaders:
                close = getattr(ld, "close", None)
                if close is not None:
                    close()
            for w in self.writers:
                close = getattr(w, "close", None)
                if close is not None:
                    close()
        logger.info("Training done")


def inference_on_dataset(
    forward_fn: Callable,  # example -> prediction dict (device + host postprocess)
    data_loader,  # callable yielding mapped examples
    evaluators: Sequence,
    warmup: int = 5,
) -> Dict[str, float]:
    """Eval loop with stage timing (reference ape/evaluation/evaluator.py:17-200):
    the log line times the images after ``warmup``. Returns the evaluators'
    metrics, and beside them the totals over every image: the seconds of
    each stage (``seconds/data``, ``seconds/compute``, ``seconds/eval``)
    and the count (``images``)."""
    total = getattr(data_loader, "__len__", lambda: None)()
    window = {"data": 0.0, "compute": 0.0, "eval": 0.0}
    totals = dict(window)
    n = 0
    t_data = time.perf_counter()
    for ex in data_loader():
        dt = time.perf_counter() - t_data
        t = time.perf_counter()
        pred = forward_fn(ex)
        dc = time.perf_counter() - t
        t = time.perf_counter()
        for ev in evaluators:
            ev.process([pred] if isinstance(pred, dict) else pred)
        de = time.perf_counter() - t
        for k, v in (("data", dt), ("compute", dc), ("eval", de)):
            window[k] += v
            totals[k] += v
        n += 1
        if n == warmup:  # reset timers after warmup (compile amortization)
            window = {k: 0.0 for k in window}
        if n % 100 == 0:
            logger.info(f"inference {n}/{total}: {window}")
        t_data = time.perf_counter()
    results = {}
    t = time.perf_counter()
    for ev in evaluators:
        results.update(ev.evaluate())
    totals["eval"] += time.perf_counter() - t
    denom = max(n - warmup, 1)
    logger.info(f"inference done: {n} images, "
                + ", ".join(f"{k} {v / denom * 1e3:.1f}ms/img" for k, v in window.items()))
    results.update({f"seconds/{k}": v for k, v in totals.items()}, images=n)
    return results
