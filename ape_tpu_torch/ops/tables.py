"""Constant tables on a device, built once per (arguments, device, dtype).

JAX folds the model's constant tables (level sizes and start offsets, grid
centers, RoPE tables, the bicubic resize matrices) into the program when it
traces. Built anew at every call, each such table on a card is a copy from
host memory that ends in a stream sync. ``device_table`` caches a table
function's result by its arguments, so a forward builds each table once per
set of shapes, device and dtype, and a table built for one set is never
returned for another.

The cached tables are read-only: every later call gets the same tensor, so
no caller may write to one. They are built outside inference mode, so a
table first built under ``torch.inference_mode`` still serves autograd.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

_CACHED = []


def device_table(fn):
    """``fn``'s result cached by its (hashable) arguments."""

    @functools.lru_cache(maxsize=64)
    @functools.wraps(fn)
    def cached(*args):
        with torch.inference_mode(False):
            return fn(*args)

    _CACHED.append(cached)
    return cached


def misses() -> int:
    """Tables built so far, over every cached table function."""
    return sum(b.cache_info().misses for b in _CACHED)


def shapes_key(spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[Tuple[int, int], ...]:
    """Level shapes as a hashable tuple of int pairs."""
    return tuple((int(h), int(w)) for h, w in spatial_shapes)
