"""Metric storage and writers (a copy of ``ape_tpu/utils/events.py``):
detectron2's EventStorage with CommonMetricPrinter, JSONWriter and the
TensorBoard and W&B writers, as the reference trainer wires them. The last
two stay inert when their package is absent (the card machine has neither)
or cannot start.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

logger = logging.getLogger("ape_tpu_torch")


class HistoryBuffer:
    def __init__(self, window: int = 20):
        self._window = deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.latest = 0.0

    def update(self, value: float):
        self._window.append(value)
        self.total += value
        self.count += 1
        self.latest = value

    def median(self) -> float:
        vals = sorted(self._window)
        return vals[len(vals) // 2] if vals else 0.0

    def avg(self) -> float:
        return sum(self._window) / max(len(self._window), 1)

    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class EventStorage:
    def __init__(self, start_iter: int = 0):
        self.iter = start_iter
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._iter_start = time.perf_counter()

    def put_scalar(self, name: str, value):
        self._history[name].update(float(value))

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def histories(self):
        return self._history

    def latest(self) -> Dict[str, float]:
        return {k: v.latest for k, v in self._history.items()}

    def step(self):
        self.iter += 1


class CommonMetricPrinter:
    """Log-line writer matching d2's format (eta/iter/losses/time/lr)."""

    def __init__(self, max_iter: int, log_period: int = 20):
        self.max_iter = max_iter
        self.log_period = log_period
        self._last_time: Optional[tuple] = None

    def write(self, storage: EventStorage):
        it = storage.iter
        eta = ""
        if self._last_time is not None:
            last_it, last_t = self._last_time
            per_iter = (time.perf_counter() - last_t) / max(it - last_it, 1)
            eta_sec = per_iter * (self.max_iter - it)
            eta = f"eta: {datetime.timedelta(seconds=int(eta_sec))}  "
        self._last_time = (it, time.perf_counter())
        losses = "  ".join(
            f"{k}: {v.median():.4g}"
            for k, v in storage.histories().items()
            if "loss" in k
        )
        extras = "  ".join(
            f"{k}: {v.latest:.4g}"
            for k, v in storage.histories().items()
            if k in ("lr", "data_time", "time")
        )
        logger.info(f"{eta}iter: {it}/{self.max_iter}  {losses}  {extras}")


class JSONWriter:
    """Append-a-line-per-period metrics.json (d2 JSONWriter format)."""

    def __init__(self, json_file: str, log_period: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")
        self.log_period = log_period

    def write(self, storage: EventStorage):
        data = {"iteration": storage.iter}
        data.update({k: v.latest for k, v in storage.histories().items()})
        self._file.write(json.dumps(data) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class TensorboardWriter:
    def __init__(self, log_dir: str, log_period: int = 20):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:  # tensorboard optional
            self._writer = None
        self.log_period = log_period

    def write(self, storage: EventStorage):
        if self._writer is None:
            return
        for k, v in storage.histories().items():
            self._writer.add_scalar(k, v.latest, storage.iter)

    def close(self):
        if self._writer is not None:
            self._writer.close()


class WandbWriter:
    """Weights & Biases writer (reference: detrex WandbWriter wired by
    tools/train_net.py:572-582). Gated on the wandb package; silently inert
    when absent or offline."""

    def __init__(self, project: str = "ape_tpu_torch", log_period: int = 20, **init_kwargs):
        try:
            import wandb

            self._run = wandb.init(project=project, reinit=True, **init_kwargs)
            self._wandb = wandb
        except Exception:
            self._run = None
            self._wandb = None
        self.log_period = log_period

    def write(self, storage: EventStorage):
        if self._run is None:
            return
        self._wandb.log(
            {k: v.latest for k, v in storage.histories().items()}, step=storage.iter
        )

    def close(self):
        if self._run is not None:
            self._run.finish()
