"""The device rule of the port's entry points: the CUDA card unless the
caller names a device, and no silent fall back to the CPU."""

from __future__ import annotations

import torch


def default_device(name: str, device):
    """``device``, or the CUDA card; with no card it raises rather than fall
    back to the CPU. ``name``: the calling function, for the message."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device; pass device='cpu' to build on the CPU")
    return torch.device("cuda")
