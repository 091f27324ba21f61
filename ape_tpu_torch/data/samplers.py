"""Training and inference samplers (a copy of ``ape_tpu/data/samplers.py``,
NumPy only): the infinite shuffled stream, repeat-factor sampling (RFS,
t=0.001) with stochastic rounding, class-aware sampling (CAS), the
per-step dataset choice by ratio, and the exact-cover split for evaluation.
Each draws from its own ``np.random.RandomState(seed)``, so a stream equals
JAX's index for index; a loader restarts one at a position by skipping
(``data.build.TrainLoader.load_state_dict``). ``MultiDatasetSampler``'s
state is its generator's (``state_dict``).
"""

from __future__ import annotations

import logging
import math
from collections import defaultdict
from typing import Iterator, List, Sequence

import numpy as np

logger = logging.getLogger("ape_tpu_torch")


def repeat_factors_from_category_frequency(
    dataset_dicts: List[dict], repeat_thresh: float = 0.001
) -> np.ndarray:
    """LVIS RFS: r(c) = max(1, sqrt(t / f(c))); r(img) = max over its categories."""
    counts: dict = defaultdict(int)
    n = len(dataset_dicts)
    for d in dataset_dicts:
        cats = {a["category_id"] for a in d.get("annotations", [])}
        for c in cats:
            counts[c] += 1
    cat_repeat = {
        c: max(1.0, math.sqrt(repeat_thresh / (cnt / n))) for c, cnt in counts.items()
    }
    factors = []
    for d in dataset_dicts:
        cats = {a["category_id"] for a in d.get("annotations", [])}
        factors.append(max([cat_repeat.get(c, 1.0) for c in cats], default=1.0))
    return np.asarray(factors, np.float64)


class TrainingSampler:
    """Infinite shuffled index stream, sharded by (rank, world_size)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0, rank: int = 0, world_size: int = 1):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            idx = g.permutation(self.size) if self.shuffle else np.arange(self.size)
            yield from idx[self.rank :: self.world_size].tolist()


class RepeatFactorTrainingSampler(TrainingSampler):
    """RFS with stochastic rounding of fractional repeat factors."""

    def __init__(self, repeat_factors: np.ndarray, seed: int = 0, rank: int = 0, world_size: int = 1):
        super().__init__(len(repeat_factors), True, seed, rank, world_size)
        self._int_part = np.floor(repeat_factors).astype(np.int64)
        self._frac_part = repeat_factors - self._int_part

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            rands = g.rand(self.size)
            reps = self._int_part + (rands < self._frac_part)
            indices = np.repeat(np.arange(self.size), reps)
            g.shuffle(indices)
            yield from indices[self.rank :: self.world_size].tolist()


class ClassAwareSampler(TrainingSampler):
    """CAS: sample a class uniformly, then an image containing it."""

    def __init__(self, dataset_dicts: List[dict], seed: int = 0, rank: int = 0, world_size: int = 1):
        super().__init__(len(dataset_dicts), True, seed, rank, world_size)
        by_class = defaultdict(list)
        for i, d in enumerate(dataset_dicts):
            for c in {a["category_id"] for a in d.get("annotations", [])}:
                by_class[c].append(i)
        self._by_class = {c: np.asarray(v) for c, v in by_class.items() if v}
        self._classes = sorted(self._by_class)

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed + self.rank)
        while True:
            c = self._classes[g.randint(len(self._classes))]
            pool = self._by_class[c]
            yield int(pool[g.randint(len(pool))])


class InferenceSampler:
    """Exact-cover split of [0, size) across hosts."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        shard = -(-size // world_size)
        self.indices = list(range(rank * shard, min((rank + 1) * shard, size)))

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class MultiDatasetSampler:
    """Weighted round-robin over per-dataset samplers: each step draws ONE
    dataset id by ``dataset_ratio`` with a shared seed so every host agrees
    (Trainer._data_loader_iter, tools/train_net.py:404-420)."""

    def __init__(self, dataset_ratios: Sequence[float], seed: int = 0):
        self.ratios = np.asarray(dataset_ratios, np.float64)
        self.ratios = self.ratios / self.ratios.sum()
        self._g = np.random.RandomState(seed)

    def next_dataset(self) -> int:
        return int(self._g.choice(len(self.ratios), p=self.ratios))

    def state_dict(self) -> dict:
        return {"rng": self._g.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self._g.set_state(state["rng"])
