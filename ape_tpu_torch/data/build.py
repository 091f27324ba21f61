"""Data loaders (counterpart of ``ape_tpu/data/build.py``): dataset dicts
from the catalog with their dataset id, empty records filtered, a sampler,
the mapper, and batches stacked on the host.

Batches stay NumPy; the trainer moves them to the card. ``TrainLoader``
maps on a prefetch thread, as JAX's does; an exception there reaches the
step that waits for the batch and fails it (JAX's thread would die and
leave the step waiting), and no batch is skipped. A record whose mapper
returns None, or whose example holds no valid target, is dropped, as
JAX drops it. A group left with no records raises (JAX's loader would wait
forever).

With ``copypaste_prob`` above 0 a group's mapper is wrapped in
``CopyPasteMapper``, which draws backgrounds from the group's own records,
as JAX's loader does.

The loader's position is part of a checkpoint: ``state_dict`` gives the
sampler indices behind the batches handed out and the mapper's generator
state after the last of them (the copy-paste mapper's and its base
mapper's), ``load_state_dict`` restarts there, so a resumed run reads the
batches the uninterrupted one would have.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ape_tpu_torch.data.catalog import DatasetCatalog
from ape_tpu_torch.data.copypaste import CopyPasteMapper
from ape_tpu_torch.data.samplers import (
    ClassAwareSampler,
    InferenceSampler,
    RepeatFactorTrainingSampler,
    TrainingSampler,
    repeat_factors_from_category_frequency,
)

logger = logging.getLogger("ape_tpu_torch")


def get_detection_dataset_dicts(
    names: Sequence[str], filter_empty: bool = True, dataset_id: int = 0
) -> List[dict]:
    dicts: List[dict] = []
    for name in [names] if isinstance(names, str) else names:
        for d in DatasetCatalog.get(name):
            d = dict(d)
            d["dataset_name"] = name
            d["dataset_id"] = dataset_id
            dicts.append(d)
    if filter_empty:
        n0 = len(dicts)
        dicts = [d for d in dicts if d.get("annotations")]
        logger.info(f"filtered empty: {n0} -> {len(dicts)}")
    return dicts


def _stack_batch(samples: List[Dict]) -> Dict:
    """Stack mapper outputs into batch arrays (all fixed-shape already)."""
    out: Dict = {}
    out["images"] = np.stack([s["image"] for s in samples])
    out["image_sizes"] = np.stack([s["image_size"] for s in samples])
    if "targets" in samples[0]:
        t0 = samples[0]["targets"]
        out["targets"] = {k: np.stack([s["targets"][k] for s in samples]) for k in t0}
    for k in ("image_id", "height", "width"):
        if k in samples[0]:
            out[k] = [s[k] for s in samples]
    if "phrases" in samples[0]:
        out["phrases"] = [s["phrases"] for s in samples]
    if "dataset_id" in samples[0]:
        out["dataset_id"] = samples[0]["dataset_id"]
    out["copypaste"] = sum(s.get("copypaste", 0) for s in samples)  # examples pasted onto
    return out


def _rng_state(mapper):
    if isinstance(mapper, CopyPasteMapper):
        return mapper.get_state()
    rng = getattr(mapper, "_rng", None)
    return None if rng is None else rng.get_state()


def _set_rng_state(mapper, state) -> None:
    if isinstance(mapper, CopyPasteMapper):
        mapper.set_state(state)
    else:
        mapper._rng.set_state(state)


class TrainLoader:
    """One dataset group's infinite loader: sampler -> mapper -> batches."""

    def __init__(self, dataset_dicts, mapper, batch_size, sampler=None, prefetch=2):
        self.dicts = dataset_dicts
        self.mapper = mapper
        self.batch_size = batch_size
        self.sampler = sampler or TrainingSampler(len(dataset_dicts))
        self._prefetch = prefetch
        self._consumed = 0  # sampler indices behind the batches handed out
        self._mapper_state = None  # the mapper's generator after the last of them
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    def state_dict(self) -> dict:
        return {"consumed": self._consumed, "mapper_rng": self._mapper_state}

    def load_state_dict(self, state: dict) -> None:
        self.close()
        self._consumed = int(state["consumed"])
        self._mapper_state = state["mapper_rng"]

    def _batches(self):
        """(batch, sampler position, mapper state) from the current position on."""
        it = iter(self.sampler)
        for _ in range(self._consumed):
            next(it)
        if self._mapper_state is not None:
            _set_rng_state(self.mapper, self._mapper_state)
        consumed = self._consumed
        while True:
            batch = []
            while len(batch) < self.batch_size:
                d = self.dicts[next(it)]
                consumed += 1
                ex = self.mapper(d)
                if ex is None:
                    continue
                if "targets" in ex and not ex["targets"]["valid"].any():
                    continue  # skip examples w/ empty GT (train_net.py:129-132)
                ex["dataset_id"] = d.get("dataset_id", 0)
                batch.append(ex)
            yield _stack_batch(batch), consumed, _rng_state(self.mapper)

    def _produce(self, q: queue.Queue, stop: threading.Event):
        try:
            for item in self._batches():
                while not stop.is_set():
                    try:
                        q.put(("batch", item), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # handed to the step that waits for the batch
            q.put(("error", e))

    def __iter__(self) -> Iterator[Dict]:
        self.close()
        if not self._prefetch:
            for batch, consumed, state in self._batches():
                self._consumed, self._mapper_state = consumed, state
                yield batch
            return
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        self._stop = stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        self._thread.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "error":
                    raise RuntimeError("data loader worker failed") from item
                batch, self._consumed, self._mapper_state = item
                yield batch
        finally:
            stop.set()

    def close(self):
        """Stop the prefetch thread and wait for it to end (it finishes the
        batch it maps: a new thread must not share the mapper with it)."""
        if self._stop is not None:
            self._stop.set()
            self._thread.join()
            self._stop = self._thread = None


def build_detection_train_loader(
    dataset_names, mapper, batch_size, sampler_name: str = "TrainingSampler",
    repeat_thresh: float = 0.001, seed: int = 0, rank: int = 0, world_size: int = 1,
    dataset_id: int = 0, filter_empty: bool = True, copypaste_prob: float = 0.0,
):
    dicts = get_detection_dataset_dicts(dataset_names, filter_empty, dataset_id)
    if not dicts:  # JAX's sampler would spin forever on an empty group
        raise ValueError(f"{list(dataset_names)}: no training records"
                         f"{' with annotations (filter_empty)' if filter_empty else ''}")
    if copypaste_prob > 0:
        # the reference's _copypaste loader draws backgrounds from the group's
        # own dataset pool (build_multi_dataset_copypaste.py:402-412, flagship
        # data config dataset_bg = the same names) at copypaste_prob=0.5
        mapper = CopyPasteMapper(mapper, dicts, prob=copypaste_prob, seed=seed)
    if sampler_name == "RepeatFactorTrainingSampler":
        rf = repeat_factors_from_category_frequency(dicts, repeat_thresh)
        sampler = RepeatFactorTrainingSampler(rf, seed, rank, world_size)
    elif sampler_name == "ClassAwareSampler":
        sampler = ClassAwareSampler(dicts, seed, rank, world_size)
    else:
        sampler = TrainingSampler(len(dicts), True, seed, rank, world_size)
    return TrainLoader(dicts, mapper, batch_size, sampler)


class EvalLoader:
    """Batch-1 evaluation loader: calling it yields each mapped example of
    this rank's share with its ``dataset_dict``."""

    def __init__(self, dicts: List[dict], mapper, sampler: InferenceSampler):
        self.dicts, self.mapper, self.sampler = dicts, mapper, sampler

    def __len__(self) -> int:
        return len(self.sampler)

    def __call__(self):
        for i in self.sampler:
            ex = self.mapper(self.dicts[i])
            if ex is None:
                continue
            ex["dataset_dict"] = self.dicts[i]
            yield ex


def build_detection_test_loader(dataset_name: str, mapper, rank: int = 0, world_size: int = 1):
    """batch-1 eval loader with exact-cover sharding."""
    dicts = get_detection_dataset_dicts([dataset_name], filter_empty=False)
    return EvalLoader(dicts, mapper, InferenceSampler(len(dicts), rank, world_size))
