"""K1's window entry and K1's body choice, as contracts checked on the CPU.

On a card the encoder's window op runs K1's window entry
(``csrc/msda_fwd.cu`` ``ape_msda_fwd_window``), which clips the pixel
offsets and forms each sampling location inside the kernel. It must equal K1
on ``window_locations`` bit for bit, because under autograd (and in the
recompute of a checkpointed layer) the encoder runs that route instead. Here
a NumPy emulation of the kernel's per-sample arithmetic (clip by
comparisons, then ``center + off / size`` in f32, a division then an
addition) is held to ``window_locations`` bit for bit on seeded offsets and
on the edge cases. The routing rules (``window_route``, ``fwd_body``) are
pure functions, tested without launching anything; ``test_torch_kernels.py``
checks on the card that the launches follow them.
"""

import numpy as np
import pytest
import torch

from ape_tpu_torch.ops import _build, msda_dispatch
from ape_tpu_torch.ops.msda import ms_deform_attn
from ape_tpu_torch.ops.msda_dispatch import (
    fwd_body,
    grid_centers,
    level_sizes,
    ms_deform_attn_window,
    window_locations,
    window_route,
)

PYRAMIDS = {
    "protocol": ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2)),
    "odd": ((12, 20), (6, 10), (3, 5)),
}


def emulate_window_locations(spatial_shapes, pixel_offsets: np.ndarray, radius: float,
                             first_query: int = 0) -> np.ndarray:
    """The window entry's locations as the kernel forms them, in f32: each
    offset clipped by comparisons (a NaN stays NaN, +-inf clip to +-R), divided
    by its level's size (the cached level_sizes table), added to the query's
    grid center (the cached grid_centers table), each step rounded once."""
    r = np.float32(radius)
    off = pixel_offsets.astype(np.float32)
    clipped = np.where(off < -r, -r, np.where(off > r, r, off))
    q = off.shape[1]
    centers = grid_centers(spatial_shapes, "cpu").numpy()[first_query:first_query + q]
    sizes = level_sizes(spatial_shapes, "cpu").numpy()
    with np.errstate(invalid="ignore"):
        step = clipped / sizes[None, None, None, :, None, :]
        return centers[None, :, None, None, None, :] + step


def _offsets(shapes, b, q, heads, points, radius, seed):
    """Seeded offsets past the radius, with every edge case at fixed places:
    NaN, +inf, -inf, exactly +R and -R, exactly 0 and -0, and values one f32
    step inside and outside R."""
    rng = np.random.RandomState(seed)
    off = rng.uniform(-2 * radius, 2 * radius, (b, q, heads, len(shapes), points, 2))
    off = off.astype(np.float32)
    r = np.float32(radius)
    edges = np.array([np.nan, np.inf, -np.inf, r, -r, 0.0, -0.0,
                      np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(np.inf)),
                      -np.nextafter(r, np.float32(0))], np.float32)
    flat = off.reshape(-1)
    idx = rng.choice(flat.size, 20 * edges.size, replace=False)
    flat[idx] = np.tile(edges, 20)
    return off


def _same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    """Equal bit for bit, NaNs equal wherever both are NaN."""
    nan = np.isnan(want)
    return bool((np.isnan(got) == nan).all() and
                (got[~nan].view(np.uint32) == want[~nan].view(np.uint32)).all())


@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
@pytest.mark.parametrize("first_query", [0, 37])
@pytest.mark.parametrize("radius", [4, 2.5])
def test_window_entry_arithmetic_equals_window_locations(pyramid, first_query, radius):
    shapes = PYRAMIDS[pyramid]
    s = sum(h * w for h, w in shapes)
    q = s - first_query - 5
    off = _offsets(shapes, 2, q, 3, 4, radius, seed=len(shapes) + first_query)
    got = emulate_window_locations(shapes, off, radius, first_query)
    want = window_locations(shapes, torch.from_numpy(off), radius, first_query).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _same_bits(got, want)
    # the edge cases are there and land where the clip puts them
    nan = np.isnan(off)
    assert nan.any() and (np.isnan(got) == nan).all()
    assert np.isinf(off).any() and np.isfinite(got[~nan]).all()


def test_offset_onto_pixel_minus_one_adds_nothing():
    """An offset of -1 px from a query in column 0 of its level, on that same
    level, lands on pixel -1 exactly in the emulation and in
    window_locations (center 0.5 / W); the gather adds 0 for it."""
    shapes = ((8, 8), (4, 4))
    s = 80
    off = np.zeros((1, s, 1, 2, 1, 2), np.float32)
    off[0, 0, 0, 0, 0] = (-1.0, 0.0)  # query 0: column 0 of the 8 x 8 level
    got = emulate_window_locations(shapes, off, 4)
    want = window_locations(shapes, torch.from_numpy(off), 4).numpy()
    assert _same_bits(got, want)
    x = np.float32(got[0, 0, 0, 0, 0, 0]) * np.float32(8) - np.float32(0.5)
    assert x == -1.0
    value = torch.randn(1, s, 1, 4, generator=torch.Generator().manual_seed(0))
    att = torch.ones(1, s, 1, 2, 1)
    att[0, 0, 0, 1] = 0.0  # query 0 keeps only its sample at pixel -1
    out = ms_deform_attn(value, shapes, torch.from_numpy(want), att)
    assert torch.equal(out[0, 0], torch.zeros(4))


@pytest.mark.parametrize("form", ["gather", "pair", "rows", "qlevel", "dense"])
@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("needs_grad", [False, True])
def test_window_route(form, device_type, needs_grad):
    """K1's window entry only for the "gather" form on a card with no
    gradient to carry; window_locations and the present route otherwise."""
    want = ("window" if form == "gather" and device_type == "cuda" and not needs_grad
            else "locations")
    assert window_route(form, device_type, needs_grad) == want


@pytest.mark.parametrize("head_dim", [8, 16, 32, 64, 128])
def test_fwd_body(head_dim):
    """K1's D = 32 body at head width 32, whatever the launch's item count,
    the general body at every other width."""
    assert fwd_body(head_dim) == ("d32" if head_dim == 32 else "general")


def test_window_op_on_cpu_takes_the_locations_route(monkeypatch):
    """On CPU tensors the window op is window_locations and the plain gather,
    with or without a gradient, and launches nothing."""
    shapes = ((8, 8), (4, 4))
    rng = np.random.RandomState(3)
    value = torch.from_numpy(rng.randn(1, 80, 2, 8).astype(np.float32))
    off = torch.from_numpy(_offsets(shapes, 1, 80, 2, 2, 4, seed=3))
    att = torch.from_numpy(rng.rand(1, 80, 2, 2, 2).astype(np.float32))
    routes = []
    monkeypatch.setattr(msda_dispatch, "window_route",
                        lambda *a: routes.append(a) or window_route(*a))
    _build.reset_launches()
    want = ms_deform_attn(value, shapes, window_locations(shapes, off, 4), att)
    with torch.inference_mode():
        got = ms_deform_attn_window(value, shapes, off, att, 4)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    o = off.clone().requires_grad_()
    ms_deform_attn_window(value, shapes, o, att, 4).sum().backward()
    assert routes == [("gather", "cpu", False), ("gather", "cpu", True)]
    assert set(_build.LAUNCHES.values()) == {0}
