"""The port's CUDA kernels against their plain versions on an NVIDIA card.

These tests (forward and backward kernels, the merged and the split MSDA
backward with K4's two bodies, the encoder's other window forward forms
K6-K9 with their D = 32 bodies, the probes K10 and K11) need a CUDA device
and the CUDA toolkit: the kernels have no CPU mode, so without a card they
skip. The file imports neither JAX nor the test conftest, so it runs on a
machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from ape_tpu_torch.ops import _build, bounds, msda_dispatch
from ape_tpu_torch.ops import msda_pair_probe as k10
from ape_tpu_torch.ops.attention import (
    TILES,
    attn_bwd_cuda,
    attn_bwd_dq_cuda,
    attn_fwd_cuda,
    attn_fwd_tiles_cuda,
    attn_tile_fits,
    global_attention,
    global_attention_plain,
)
from ape_tpu_torch.ops.msda import level_start_index, ms_deform_attn
from ape_tpu_torch.ops.msda_dispatch import (
    BODIES,
    fwd_body,
    ms_deform_attn_exact,
    ms_deform_attn_window,
    msda_bwd_cuda,
    msda_bwd_offatt_cuda,
    msda_bwd_value_cuda,
    msda_fwd_cuda,
    msda_fwd_window_cuda,
    window_locations,
)
from ape_tpu_torch.ops import msda_window_forms as forms
from ape_tpu_torch.ops.msda_window_forms import window_form_cuda, window_plain
from ape_tpu_torch.tools.msda_race import PYRAMIDS, RADIUS, window_inputs
from ape_tpu_torch.tools.pair_probe import BOUND as PROBE_BOUND, pair_inputs

pytestmark = pytest.mark.cuda

# bf16 rounds the value and the output once each; f32 differs only by order
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_kernel_matches_plain(device, dtype):
    rng = np.random.RandomState(0)
    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(2, s, 8, 32).astype(np.float32)).to(device, dtype)
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, 37, 8, 3, 4, 2)).astype(np.float32)).to(device)
    att = torch.from_numpy(rng.rand(2, 37, 8, 3, 4).astype(np.float32)).to(device, dtype)
    got = msda_fwd_cuda(value, shapes, loc, att).float()
    want = ms_deform_attn(value.float(), shapes, loc, att.float())
    assert got.shape == (2, 37, 256)
    assert float((got - want).abs().max()) < TOL[dtype]


def _window_edge_offsets(shapes, b, q, heads, radius, first_query, seed=9):
    """Seeded pixel offsets (B, Q, H, L, P, 2) spread past the radius, with
    edge cases at fixed places: NaN, +-inf, exactly +-R, exactly 0 and -0;
    and for each query in column 0 of its level's grid, point 1's x offset
    on that same level at -1 px, which lands on pixel -1 exactly (center
    0.5 / W; every width here is a power of 2)."""
    rng = np.random.RandomState(seed)
    off = rng.uniform(-1.5 * radius, 1.5 * radius, (b, q, heads, len(shapes), 4, 2))
    off = off.astype(np.float32)
    edges = np.array([np.nan, np.inf, -np.inf, radius, -radius, 0.0, -0.0, np.nan], np.float32)
    flat = off.reshape(-1)
    flat[rng.choice(flat.size, 8 * 64, replace=False)] = np.tile(edges, 64)
    start = 0
    for lvl, (hl, wl) in enumerate(shapes):
        rows = np.arange(start, start + hl * wl, wl) - first_query  # column 0 of the level
        rows = rows[(rows >= 0) & (rows < q)]
        off[:, rows, :, lvl, 1, 0] = -1.0
        start += hl * wl
    return off


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [8, 3])
def test_msda_d32_body_equals_general_body(device, dtype, heads):
    """K1's D = 32 body against its general body, bit for bit, with every
    level's samples on the edges (x = -1 and y = -1 exactly, the last pixel,
    a right corner outside); B * Q * H = 592 at 8 heads and 222 at 3, where
    the last warp holds two items and two lanes' worth of items past the end."""
    shapes, value, loc, att, _ = _msda_edge_inputs(device, dtype, heads, 32)
    loc[0, 5, 0, 1, 2] = float("nan")
    loc[1, 7, heads - 1, 2, 1, 0] = float("inf")
    bodies = {b: msda_fwd_cuda(value, shapes, loc, att, body=b) for b in BODIES}
    assert torch.equal(bodies["d32"], bodies["general"])
    want = ms_deform_attn(value.float(), shapes, loc, att.float())
    assert float((bodies["d32"].float() - want).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,first_query", [(8, 0), (8, 100), (3, 7)])
def test_msda_window_entry_equals_k1_on_window_locations(device, dtype, heads, first_query):
    """K1's window entry against K1 on window_locations, bit for bit with each
    body, on offsets holding NaN, +-inf, exactly +-R, 0 and -0 and offsets
    landing on pixel -1, for the queries from first_query on; and against
    the plain version."""
    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    q, radius = s - first_query - 3, 4
    rng = np.random.RandomState(10)
    value = torch.from_numpy(rng.randn(2, s, heads, 32).astype(np.float32)).to(device, dtype)
    off = torch.from_numpy(_window_edge_offsets(shapes, 2, q, heads, radius, first_query))
    off = off.to(device)
    att = torch.from_numpy(rng.rand(2, q, heads, 3, 4).astype(np.float32)).to(device, dtype)
    loc = window_locations(shapes, off, radius, first_query=first_query).contiguous()
    for b in BODIES:
        got = msda_fwd_window_cuda(value, shapes, off, att, radius, first_query, body=b)
        assert torch.equal(got, msda_fwd_cuda(value, shapes, loc, att, body=b)), b
    assert bool(torch.isfinite(got).all())
    want = ms_deform_attn(value.float(), shapes, loc, att.float())
    assert float((got.float() - want).abs().max()) < TOL[dtype]


def test_msda_fwd_refuses_unaligned_inputs_at_head_width_32(device):
    """At head width 32 both K1 entries refuse value, locations or offsets
    that do not start 16-byte aligned, and launch nothing."""
    shapes, value, loc, att, _ = _msda_edge_inputs(device, torch.float32, 8, 32)

    def shifted(t):  # the same values 8 bytes past an aligned address
        buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=device)
        out = buf[2:].view(t.shape)
        out.copy_(t)
        return out

    before = dict(_build.LAUNCHES)
    for args in ((shifted(value), loc), (value, shifted(loc))):
        with pytest.raises(ValueError, match="16-byte"):
            msda_fwd_cuda(args[0], shapes, args[1], att)
        with pytest.raises(ValueError, match="16-byte"):
            msda_fwd_window_cuda(args[0], shapes, args[1], att, 4)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="no body"):
        msda_fwd_cuda(value[..., :16].contiguous(), shapes, loc, att, body="d32")


# torch.profiler windows a check reads before it fails, each of
# PROFILE_CALLS calls, a second apart: a window at times comes back with no
# device activity (chip_smoke.kernel_ms profiles again too), on an H100 once
# three short windows in a row
PROFILE_TRIES, PROFILE_CALLS = 5, 5


def _launched_kernels(fn, part: str):
    """The set of names of the kernels with ``part`` in their name that fn()
    ran on the card, by torch.profiler over PROFILE_CALLS calls; a window
    that recorded none of them is profiled again, at most PROFILE_TRIES
    times in all."""
    import time

    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_CALLS):
                fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and part in e.name}
        if names:
            return names
        time.sleep(1.0)
    pytest.fail(f"torch.profiler recorded no {part} in {PROFILE_TRIES} windows")


def _launched_body(monkeypatch, fn):
    """Which of K1's bodies fn() launched: by the body code its one call of
    the library's K1 entry passed (``_entries``), and by the name of the one
    K1 kernel it ran on the card, which must agree."""
    calls = [args for name, args in _entries(monkeypatch, fn) if name == "ape_msda_fwd"]
    assert len(calls) == 1, calls
    body = {code: body for body, code in BODIES.items()}[calls[0][-2]]
    (name,) = _launched_kernels(fn, "msda_fwd_kernel")
    assert ("msda_fwd_kernel_d32" in name) == (body == "d32"), (body, name)
    return body


@pytest.mark.parametrize("items", [8, 4800, 7200, 174592])
def test_msda_fwd_takes_the_d32_body_at_head_width_32(device, monkeypatch, items):
    """At head width 32 launches of few items (down to one query) and of many
    take the D = 32 body, the decoder's 4,800 and 7,200 items among them; at
    64 the general body. Both bodies agree bit for bit."""
    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(11)
    for dim in (32, 64):
        value = torch.from_numpy(rng.randn(1, s, 8, dim).astype(np.float32)).to(device)
        q = items // 8
        loc = torch.from_numpy(rng.rand(1, q, 8, 3, 4, 2).astype(np.float32)).to(device)
        att = torch.from_numpy(rng.rand(1, q, 8, 3, 4).astype(np.float32)).to(device)
        assert _launched_body(monkeypatch,
                              lambda: msda_fwd_cuda(value, shapes, loc, att)) == fwd_body(dim)
    assert fwd_body(32) == "d32"
    value = value[..., :32].contiguous()
    assert torch.equal(msda_fwd_cuda(value, shapes, loc, att, body="d32"),
                       msda_fwd_cuda(value, shapes, loc, att, body="general"))


def test_msda_window_entry_serves_inference_only(device):
    """Under torch.inference_mode (and no_grad) the encoder's window op
    launches K1's window entry alone; under autograd window_locations, K1
    and K2, with the same forward output."""
    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(12)
    value = torch.from_numpy(rng.randn(2, s, 8, 32).astype(np.float32)).to(device)
    off = torch.from_numpy(rng.randn(2, s, 8, 3, 4, 2).astype(np.float32) * 3).to(device)
    att = torch.from_numpy(rng.rand(2, s, 8, 3, 4).astype(np.float32)).to(device)
    outs = {}
    for mode in ("inference", "no_grad"):
        _build.reset_launches()
        with torch.inference_mode() if mode == "inference" else torch.no_grad():
            outs[mode] = ms_deform_attn_window(value, shapes, off, att, 4)
        assert {k: n for k, n in _build.LAUNCHES.items() if n} == {"msda_fwd_window": 1}, mode
    _build.reset_launches()
    o = off.clone().requires_grad_()
    out = ms_deform_attn_window(value, shapes, o, att, 4)
    out.backward(torch.ones_like(out))
    assert {k: n for k, n in _build.LAUNCHES.items() if n} == {"msda_fwd": 1, "msda_bwd": 1}
    assert torch.equal(outs["inference"], out.detach()) and torch.equal(outs["no_grad"],
                                                                       out.detach())


# Sequence lengths the tensor-core fragments make hard (one row, a ragged
# n8 or k16 tile, one past or short of a 64-row tile, the global blocks'
# 4096) at every head width, beside the earlier cases.
ATTN_SIZES = [(333, 64), (64, 32), (200, 128),
              *((n, dh) for n in (1, 15, 17, 63, 65, 4096) for dh in (32, 64, 128))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dh", ATTN_SIZES)
def test_attention_kernel_matches_plain(device, dtype, n, dh):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, n, dh).astype(np.float32)).to(device, dtype)
               for _ in range(3))
    got = attn_fwd_cuda(q, k, v, dh**-0.5).float()
    want = global_attention_plain(q.float(), k.float(), v.float(), dh**-0.5)
    assert float((got - want).abs().max()) < TOL[dtype]


def _msda_grad_inputs(device, dtype, b=2, q=37, seed=2):
    rng = np.random.RandomState(seed)
    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(b, s, 8, 32).astype(np.float32)).to(device, dtype)
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (b, q, 8, 3, 4, 2)).astype(np.float32)).to(device)
    att = torch.from_numpy(rng.rand(b, q, 8, 3, 4).astype(np.float32)).to(device, dtype)
    grad = torch.from_numpy(rng.randn(b, q, 256).astype(np.float32)).to(device, dtype)
    return shapes, value, loc, att, grad


# f32: the kernel sums d_value with atomics in a run-dependent order, and
# d_loc carries a factor of the level size, so 1e-4 absolute on values of
# order 10. bf16: value and grad are rounded to 8 bits before both versions.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# Each backward output over its own largest entry, as chip_smoke.py holds
# them (ops/bounds.py): f32 sums in another order; bf16 rounds the gradients
# (2^-8) and, in K5-dq, dS before dS K (tests/test_torch_attention.py
# emulates it).
GRAD_BOUNDS = {getattr(torch, k): v for k, v in bounds.GRAD_BOUNDS.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_backward_kernel_matches_autograd(device, dtype):
    shapes, value, loc, att, grad = _msda_grad_inputs(device, dtype)
    got = msda_bwd_cuda(value, shapes, loc, att, grad)
    leaves = [value.detach().float().requires_grad_(), loc.clone().requires_grad_(),
              att.detach().float().requires_grad_()]
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    want = torch.autograd.grad(out, leaves, grad.float())
    for name, g, w in zip(("value", "loc", "att"), got, want):
        assert g.shape == w.shape, name
        scale = max(1.0, float(w.abs().max()))
        assert float((g.float() - w).abs().max()) < GRAD_TOL[dtype] * scale, name


def _msda_edge_inputs(device, dtype, heads, dim, seed=8):
    """Seeded MSDA inputs (batch 2, 37 queries, three levels) with each
    level's points 0-3 placed on the edges: x = -1 exactly (the window
    clip's edge, where d_loc is one-sided), y = -1, the last pixel (x = W - 1,
    y = H - 1), and x = W - 1/2 (its right corner outside)."""
    rng = np.random.RandomState(seed)
    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    b, q = 2, 37
    value = rng.randn(b, s, heads, dim).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (b, q, heads, 3, 4, 2)).astype(np.float32)
    for lvl, (hl, wl) in enumerate(shapes):
        loc[:, :, :, lvl, 0, 0] = -0.5 / wl
        loc[:, :, :, lvl, 1, 1] = -0.5 / hl
        loc[:, :, :, lvl, 2] = ((wl - 0.5) / wl, (hl - 0.5) / hl)
        loc[:, :, :, lvl, 3, 0] = 1.0
    att = rng.rand(b, q, heads, 3, 4).astype(np.float32)
    grad = rng.randn(b, q, heads * dim).astype(np.float32)
    return (shapes, torch.from_numpy(value).to(device, dtype), torch.from_numpy(loc).to(device),
            torch.from_numpy(att).to(device, dtype), torch.from_numpy(grad).to(device, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim", [(8, 32), (3, 32), (8, 64)])
def test_msda_backward_kernel_edges_and_partial_warps(device, dtype, heads, dim):
    """K2 against autograd of the plain version, each output over its own
    largest entry: on the D = 32 body (8 lanes an item, 4 items a warp) with
    B * Q * H = 592 and, at 3 heads, 222, not a multiple of 4 (the last
    warp's items past the end stay empty), and on the other body (D = 64);
    every sample set of each level holds the edge cases."""
    shapes, value, loc, att, grad = _msda_edge_inputs(device, dtype, heads, dim)
    d_value, d_loc, d_att = msda_bwd_cuda(value, shapes, loc, att, grad)
    assert (d_value.dtype, d_loc.dtype, d_att.dtype) == (dtype, torch.float32, dtype)
    leaves = [value.detach().float().requires_grad_(), loc.clone().requires_grad_(),
              att.detach().float().requires_grad_()]
    want = torch.autograd.grad(ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]),
                               leaves, grad.float())
    for name, g, w in zip(("value", "loc", "att"), (d_value, d_loc, d_att), want):
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        rel = float((g.float() - w).abs().max()) / float(w.abs().max())
        assert rel <= GRAD_BOUNDS[dtype], (name, rel)


def test_msda_autograd_runs_the_kernels(device):
    shapes, value, loc, att, grad = _msda_grad_inputs(device, torch.float32, q=sum(
        h * w for h, w in ((16, 16), (8, 8), (4, 4))))
    _build.reset_launches()
    off = torch.zeros(2, value.shape[1], 8, 3, 4, 2, device=device, requires_grad=True)
    v = value.clone().requires_grad_()
    out = ms_deform_attn_window(v, shapes, off, att, 2)
    out.backward(grad)
    assert _build.LAUNCHES["msda_fwd"] == 1 and _build.LAUNCHES["msda_bwd"] == 1
    assert torch.isfinite(off.grad).all() and torch.isfinite(v.grad).all()


# The split kernels against the merged one, each output over its own largest
# entry: the same rounding, boundary test and per-sample expressions
# (msda_sample.cuh), so f32 differs only by FMA contraction and atomic order;
# bf16 outputs may sit one bf16 step apart.
SPLIT_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_split_backward_kernels_match_autograd_and_merged(device, dtype, body):
    """K3 (d_loc, d_att; each body) and K4 (d_value) against autograd of the
    plain version and against K2 on the same inputs; K3's D = 32 body equals
    K2's d_loc and d_att bit for bit (d_att rounded once to the weights'
    dtype)."""
    shapes, value, loc, att, grad = _msda_grad_inputs(device, dtype)
    d_loc, d_att = msda_bwd_offatt_cuda(value, shapes, loc, att, grad, body=body)
    d_value = msda_bwd_value_cuda(shapes, loc, att, grad)
    assert (d_value.dtype, d_loc.dtype, d_att.dtype) == (dtype, torch.float32, dtype)
    leaves = [value.detach().float().requires_grad_(), loc.clone().requires_grad_(),
              att.detach().float().requires_grad_()]
    want = torch.autograd.grad(ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]),
                               leaves, grad.float())
    merged = msda_bwd_cuda(value, shapes, loc, att, grad)
    for name, g, w, m in zip(("value", "loc", "att"), (d_value, d_loc, d_att), want, merged):
        assert g.shape == w.shape, name
        scale = max(1.0, float(w.abs().max()))
        assert float((g.float() - w).abs().max()) < GRAD_TOL[dtype] * scale, name
        m_scale = max(float(m.float().abs().max()), 1e-30)
        assert float((g.float() - m.float()).abs().max()) <= SPLIT_TOL[dtype] * m_scale, name
    if body == "d32":
        assert torch.equal(d_loc, merged[1]) and torch.equal(d_att, merged[2])
    f32_att = msda_bwd_offatt_cuda(value, shapes, loc, att.float(), grad, body=body)[1]
    assert f32_att.dtype == torch.float32
    if body == "d32":
        assert torch.equal(f32_att, msda_bwd_cuda(value, shapes, loc, att.float(), grad)[2])


def test_msda_split_route_serves_the_encoder_only(device, monkeypatch):
    """With BWD_MERGED off, the window mode's backward launches K3 and K4 and
    gives K2's gradients; the exact mode (the decoder's) stays on K2."""
    shapes, value, _, att, grad = _msda_grad_inputs(device, torch.float32, q=sum(
        h * w for h, w in ((16, 16), (8, 8), (4, 4))))
    off = torch.from_numpy(np.random.RandomState(4).randn(*att.shape, 2).astype(np.float32))
    grads = {}
    for merged in (True, False):
        monkeypatch.setattr(msda_dispatch, "BWD_MERGED", merged)
        _build.reset_launches()
        o = off.to(device).requires_grad_()
        v = value.clone().requires_grad_()
        ms_deform_attn_window(v, shapes, o, att, 2).backward(grad)
        grads[merged] = (v.grad, o.grad)
        split = {k: _build.LAUNCHES[k] for k in ("msda_bwd", "msda_bwd_offatt", "msda_bwd_value")}
        assert split == ({"msda_bwd": 1, "msda_bwd_offatt": 0, "msda_bwd_value": 0} if merged
                         else {"msda_bwd": 0, "msda_bwd_offatt": 1, "msda_bwd_value": 1})
    for g, m in zip(grads[False], grads[True]):
        assert float((g - m).abs().max()) <= SPLIT_TOL[torch.float32] * float(m.abs().max())
    _build.reset_launches()
    loc = torch.rand(2, value.shape[1], 8, 3, 4, 2, device=device, requires_grad=True)
    ms_deform_attn_exact(value.clone().requires_grad_(), shapes, loc, att).backward(grad)
    assert _build.LAUNCHES["msda_bwd"] == 1 and _build.LAUNCHES["msda_bwd_offatt"] == 0


class _EntrySpy:
    """The kernel library with a record of the C entries called through it,
    each with its arguments (by the library's calls, not the profiler's
    record of kernel names, which can miss launches late in a long
    process)."""

    def __init__(self, lib):
        self._lib, self.calls = lib, []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*args):
            self.calls.append((name, args))
            return fn(*args)

        return call


def _entries(monkeypatch, fn):
    """The (entry, arguments) calls fn() made into the kernel library."""
    spy = _EntrySpy(_build.library())
    monkeypatch.setattr(_build, "library", lambda: spy)
    fn()
    monkeypatch.undo()
    return spy.calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_msda_bwd_value_d32_matches_k2_and_general(device, monkeypatch, pyramid, dtype):
    """K4's D = 32 body (8 lanes an item, one float4 reduction a lane and
    corner) on one encoder layer's window inputs at each pyramid: its
    d_value within SPLIT_BOUNDS of K2's and of K4's general body (the same
    addends as K2's, the atomics in another order); the wrapper takes it at
    head width 32."""
    shapes, batch = PYRAMIDS[pyramid]
    value, off, att = window_inputs(torch.Generator().manual_seed(13), shapes, batch, "ring",
                                    dtype, device)
    loc = window_locations(shapes, off, RADIUS).contiguous()
    grad = torch.randn(batch, value.shape[1], 256, generator=torch.Generator().manual_seed(14))
    grad = grad.to(device, dtype)
    merged = msda_bwd_cuda(value, shapes, loc, att, grad)[0]
    bodies = {b: msda_bwd_value_cuda(shapes, loc, att, grad, body=b) for b in BODIES}
    bound = bounds.SPLIT_BOUNDS[str(dtype).split(".")[-1]]
    for body, got in bodies.items():
        assert got.dtype == dtype and got.shape == merged.shape
        assert bool(torch.isfinite(got).all())
        for ref in (merged, bodies["general"]):
            scale = float(ref.float().abs().max())
            assert float((got.float() - ref.float()).abs().max()) <= bound * scale, body

    def run():
        return msda_bwd_value_cuda(shapes, loc, att, grad)

    calls = _entries(monkeypatch, run)
    assert [(name, args[-2]) for name, args in calls] == [("ape_msda_bwd_value", BODIES["d32"])]
    (name,) = _launched_kernels(run, "msda_bwd_value_kernel")
    assert "msda_bwd_value_kernel_d32" in name, name


BF16_MSDA_BOUND = bounds.FWD_BOUNDS["bfloat16"]["msda"]


@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_dense_d32_matches_k1_window_plain_and_general(device, monkeypatch, pyramid):
    """K9's D = 32 body (bf16: each tile's weight matrix against the staged
    boxes on the tensor cores, the finer levels from device memory) in the
    whole window op (+ K1 on the narrow query levels) at both pyramids:
    within the bf16 MSDA bound of K1's window entry, of the plain version
    and of K9's general body; every K9 launch takes the D = 32 body."""
    shapes, batch = PYRAMIDS[pyramid]
    value, off, att = window_inputs(torch.Generator().manual_seed(15), shapes, batch, "ring",
                                    torch.bfloat16, device)
    plan = forms.plan_layer("dense", shapes, 32, 2, RADIUS)
    assert {x.body for x in plan if x.kernel == "msda_fwd_dense"} == {"d32"}
    got = window_form_cuda("dense", value, shapes, off, att, RADIUS)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    for ref in (msda_fwd_window_cuda(value, shapes, off, att, RADIUS),
                window_plain(value, shapes, off, att, RADIUS),
                window_form_cuda("dense", value, shapes, off, att, RADIUS, body="general")):
        assert float((got.float() - ref.float()).abs().max()) <= BF16_MSDA_BOUND

    def run():
        return window_form_cuda("dense", value, shapes, off, att, RADIUS)

    calls = _entries(monkeypatch, run)
    dense = [name for name, _ in calls if name.startswith("ape_msda_fwd_dense")]
    n_dense = sum(x.kernel == "msda_fwd_dense" for x in plan)
    assert dense == ["ape_msda_fwd_dense_d32"] * n_dense
    (name,) = _launched_kernels(run, "msda_fwd_dense_kernel")
    assert "msda_fwd_dense_kernel_d32" in name, name


DENSE_STORE_BOUND = bounds.DENSE_STORE_BOUND


@pytest.mark.parametrize("att_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_dense_d32_store_mode_holds_the_f32_plain_version(device, pyramid, att_dtype):
    """Each K9 launch of the bf16 plan with out mode "store" (f32 output):
    its query level's rows within 2e-4 of the largest output of the plain
    version on the same inputs upcast to f32."""
    shapes, batch = PYRAMIDS[pyramid]
    value, off, att = window_inputs(torch.Generator().manual_seed(16), shapes, batch, "ring",
                                    torch.bfloat16, device)
    att = att.to(att_dtype)
    starts, _ = level_start_index(shapes)
    for x in forms.plan_layer("dense", shapes, 32, 2, RADIUS):
        if x.kernel != "msda_fwd_dense":
            continue
        out = torch.zeros(batch, value.shape[1], 256, device=device)
        forms.launch_cuda(dataclasses.replace(x, out_mode="store"), value, shapes, off, att, out,
                          RADIUS)
        (lq,) = x.query_levels
        rows = slice(starts[lq], starts[lq] + shapes[lq][0] * shapes[lq][1])
        want = forms.window_qlevel_plain(value.float(), shapes, lq, off, att.float(), RADIUS)
        rel = float((out[:, rows] - want).abs().max()) / float(want.abs().max())
        assert rel <= DENSE_STORE_BOUND, (lq, rel)


def test_dense_d32_nan_and_inf_offsets(device):
    """NaN and +-inf offsets, exactly +-R, 0 and -0, and offsets landing on
    pixel -1, through K9's D = 32 body: finite; a NaN sample adds nothing
    (the output equals, bit for bit, that with the sample's weight and
    offset at 0); +-inf clip to +-R, as K1's window entry does, within the
    bf16 bound of it and of the plain version."""
    shapes = ((8, 128), (4, 64), (2, 32))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(17)
    off_np = _window_edge_offsets(shapes, 2, s, 8, RADIUS, 0, seed=18)
    att_np = rng.rand(2, s, 8, 3, 4).astype(np.float32)
    value = torch.from_numpy(rng.randn(2, s, 8, 32).astype(np.float32)).to(device, torch.bfloat16)

    def run(off_np, att_np):
        off = torch.from_numpy(off_np).to(device)
        att = torch.from_numpy(att_np).to(device, torch.bfloat16)
        return window_form_cuda("dense", value, shapes, off, att, RADIUS), off, att

    got, off, att = run(off_np, att_np)
    assert bool(torch.isfinite(got).all())
    nan = np.isnan(off_np).any(-1)
    assert nan[:, :128 * 8].any()  # NaN samples on the K9 query level
    off0, att0 = off_np.copy(), att_np.copy()
    off0[nan], att0[nan] = 0.0, 0.0
    assert torch.equal(got, run(off0, att0)[0])
    for ref in (msda_fwd_window_cuda(value, shapes, off, att, RADIUS),
                window_plain(value, shapes, off, att, RADIUS)):
        assert float((got.float() - ref.float()).abs().max()) <= BF16_MSDA_BOUND


def test_dense_d32_eight_points(device):
    """K9's D = 32 body with 8 points a level, more than a query row's 4
    threads place at once (two chunks of points; W's rows zeroed over the
    staged rows instead of reset entry by entry): within the bf16 bound of
    the plain version and of K1's window entry, in both out modes."""
    shapes = ((8, 128), (16, 256), (4, 64))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(19)
    value = torch.from_numpy(rng.randn(1, s, 8, 32).astype(np.float32)).to(device, torch.bfloat16)
    off = torch.from_numpy(rng.uniform(-6, 6, (1, s, 8, 3, 8, 2)).astype(np.float32)).to(device)
    att = torch.from_numpy(rng.rand(1, s, 8, 3, 8).astype(np.float32) / 12).to(device,
                                                                              torch.bfloat16)
    got = window_form_cuda("dense", value, shapes, off, att, RADIUS)
    for ref in (msda_fwd_window_cuda(value, shapes, off, att, RADIUS),
                window_plain(value, shapes, off, att, RADIUS)):
        assert float((got.float() - ref.float()).abs().max()) <= BF16_MSDA_BOUND
    starts, _ = level_start_index(shapes)
    for x in forms.plan_layer("dense", shapes, 32, 2, RADIUS):
        if x.kernel != "msda_fwd_dense":
            continue
        assert x.body == "d32"
        out = torch.zeros(1, s, 256, device=device)
        forms.launch_cuda(dataclasses.replace(x, out_mode="store"), value, shapes, off, att, out,
                          RADIUS)
        (lq,) = x.query_levels
        rows = slice(starts[lq], starts[lq] + shapes[lq][0] * shapes[lq][1])
        want = forms.window_qlevel_plain(value.float(), shapes, lq, off, att.float(), RADIUS)
        assert float((out[:, rows] - want).abs().max()) <= DENSE_STORE_BOUND * float(
            want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dh", ATTN_SIZES)
def test_attention_backward_kernels_match_autograd(device, dtype, n, dh):
    rng = np.random.RandomState(3)
    q, k, v, go = (torch.from_numpy(rng.randn(2, 3, n, dh).astype(np.float32)).to(device, dtype)
                   for _ in range(4))
    out, lse = attn_fwd_cuda(q, k, v, dh**-0.5, with_lse=True)
    got = attn_bwd_cuda(q, k, v, out, go, lse, dh**-0.5)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(global_attention_plain(*leaves, dh**-0.5), leaves, go.float())
    ref_lse = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) * dh**-0.5, -1)
    assert float((lse - ref_lse).abs().max()) < 1e-4
    for name, g, w in zip("qkv", got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g.float() - w).abs().max()) < GRAD_TOL[dtype] * scale, name
    _build.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    global_attention(*leaves, dh**-0.5).backward(go)
    names = ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq")
    assert {k: _build.LAUNCHES[k] for k in names} == dict.fromkeys(names, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dh", ATTN_SIZES)
def test_attention_dq_kernel_returns_delta(device, dtype, n, dh):
    """K5-dq with the delta folded in, in one launch: dQ against autograd of
    the plain attention, and the delta it returns against the plain row sum
    of O * dO within f32 rounding (dh terms, each side rounding its own sum)."""
    rng = np.random.RandomState(4)
    q, k, v, go = (torch.from_numpy(rng.randn(2, 3, n, dh).astype(np.float32)).to(device, dtype)
                   for _ in range(4))
    out, lse = attn_fwd_cuda(q, k, v, dh**-0.5, with_lse=True)
    before = _build.LAUNCHES["attn_bwd_dq"]
    dq, delta = attn_bwd_dq_cuda(q, k, v, out, go, lse, dh**-0.5)
    assert _build.LAUNCHES["attn_bwd_dq"] == before + 1
    assert dq.dtype == dtype and delta.dtype == torch.float32 and delta.shape == (2, 3, n)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    (want,) = torch.autograd.grad(global_attention_plain(*leaves, dh**-0.5), leaves[:1], go.float())
    # at N = 1 the softmax is constant and dQ exactly 0: the floor keeps the
    # bound finite there
    scale = max(float(want.abs().max()), 1e-2)
    assert float((dq.float() - want).abs().max()) <= GRAD_BOUNDS[dtype] * scale
    prod = out.float() * go.float()
    assert bool(((delta - prod.sum(-1)).abs() <= 2 * dh * 2**-24 * prod.abs().sum(-1)).all())


# (form, body): K6 (pair), K7 (rows, + K6) and K8 (qlevel) with each of their
# bodies; K9 (dense, + K1) with its default (its D = 32 body in bf16)
FORM_BODIES = [("pair", "d32"), ("pair", "general"), ("rows", "d32"), ("rows", "general"),
               ("qlevel", "d32"), ("qlevel", "general"), ("dense", None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
@pytest.mark.parametrize("form,body", FORM_BODIES)
def test_window_form_kernels_match_plain_and_k1(device, form, body, pyramid, dtype):
    """K6 (all pairs), K7 (+ K6), K8 (each body) and K9 (+ K1) as the whole
    window op at the protocol pyramid (batch 1) and the 4-scale one (batch
    2), radius 4, against the plain version and against K1 on the same
    inputs; the D = 32 bodies of K6, K7 and K8 equal to K1's window entry
    and to K1 on ``window_locations`` bit for bit."""
    shapes, batch = PYRAMIDS[pyramid]
    value, off, att = window_inputs(torch.Generator().manual_seed(5), shapes, batch, "ring", dtype,
                                    device)
    got = window_form_cuda(form, value, shapes, off, att, RADIUS, body=body)
    assert got.dtype == dtype and got.shape == (batch, value.shape[1], 256)
    plain = window_plain(value, shapes, off, att, RADIUS)
    k1 = msda_fwd_cuda(value, shapes, window_locations(shapes, off, RADIUS).contiguous(), att)
    assert float((got.float() - plain.float()).abs().max()) < TOL[dtype]
    assert float((got.float() - k1.float()).abs().max()) < TOL[dtype]
    if body == "d32":
        assert torch.equal(got, k1)
        assert torch.equal(got, msda_fwd_window_cuda(value, shapes, off, att, RADIUS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_qlevel_d32_many_groups_equal_k1_window(device, pyramid, dtype):
    """K8's D = 32 body under a shared-memory budget that splits most query
    levels into two or more groups: each later group continues the f32
    partial, and the whole op still equals K1's window entry bit for bit."""
    shapes, batch = PYRAMIDS[pyramid]
    value, off, att = window_inputs(torch.Generator().manual_seed(8), shapes, batch, "ring", dtype,
                                    device)
    budget = 12 * 1024 * value.element_size()
    plan = forms.plan_layer("qlevel", shapes, 32, value.element_size(), RADIUS, budget)
    assert len(plan) >= 2 * len(shapes)
    before = _build.LAUNCHES["msda_fwd_qlevel"]
    got = window_form_cuda("qlevel", value, shapes, off, att, RADIUS, budget=budget)
    assert _build.LAUNCHES["msda_fwd_qlevel"] - before == len(plan)
    assert torch.equal(got, msda_fwd_window_cuda(value, shapes, off, att, RADIUS))


def test_qlevel_d32_tensor_map_failure_raises(device):
    """A box the TMA cannot take (257 pixels along an axis; a box side is at
    most 256) makes the tensor-map encode fail: K8's D = 32 wrapper raises,
    launches nothing, and runs no other body in its place."""
    shapes, batch = PYRAMIDS["protocol"]
    value, off, att = window_inputs(torch.Generator().manual_seed(9), shapes, batch, "ring",
                                    torch.bfloat16, device)
    launch = forms.plan_layer("qlevel", shapes, 32, 2, RADIUS)[0]
    bad = dataclasses.replace(launch, boxes=((1, 257),) + launch.boxes[1:])
    out = torch.zeros(batch, value.shape[1], 256, dtype=value.dtype, device=device)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="tensor map"):
        forms.launch_cuda(bad, value, shapes, off, att, out, RADIUS)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before and not out.any()


# The kernels each form's D = 32 plan launches per layer, by kernel name
# (five levels): K6 only for "pair"; K7 one a query level and K6 on the
# finer pairs for "rows"
D32_FORM_KERNELS = {"pair": {"msda_fwd_pair_kernel_d32": 25},
                    "rows": {"msda_fwd_rows_kernel_d32": 5, "msda_fwd_pair_kernel_d32": 10}}


@pytest.mark.parametrize("form", sorted(D32_FORM_KERNELS))
def test_pair_and_rows_d32_route_to_their_bodies(device, monkeypatch, form):
    """At head width 32 the "pair" and "rows" ops call only the D = 32
    entries, as many times a layer as their plans say, and the card runs
    only the D = 32 bodies' kernels, by the profiler's kernel names."""
    shapes, batch = PYRAMIDS["protocol"]
    value, off, att = window_inputs(torch.Generator().manual_seed(21), shapes, batch, "ring",
                                    torch.bfloat16, device)

    def run():
        return window_form_cuda(form, value, shapes, off, att, RADIUS)

    calls = [name for name, _ in _entries(monkeypatch, run) if name.startswith("ape_msda_fwd")]
    want = D32_FORM_KERNELS[form]
    assert sorted(calls) == sorted(f"ape_{k.replace('_kernel_d32', '_d32')}"
                                   for k, n in want.items() for _ in range(n))
    names = _launched_kernels(run, "msda_fwd_")
    assert {k for k in want if any(k in name for name in names)} == set(want)
    assert all(any(k in name for k in want) for name in names), names


@pytest.mark.parametrize("form", ["pair", "rows"])
def test_pair_and_rows_d32_tensor_map_failure_raises(device, form):
    """A box the TMA cannot take (257 pixels along an axis) makes the
    tensor-map encode fail: K6's and K7's D = 32 wrappers raise, launch
    nothing, and run no other body in its place."""
    shapes, batch = PYRAMIDS["protocol"]
    value, off, att = window_inputs(torch.Generator().manual_seed(22), shapes, batch, "ring",
                                    torch.bfloat16, device)
    kernel = {"pair": "msda_fwd_pair", "rows": "msda_fwd_rows"}[form]
    launch = next(x for x in forms.plan_layer(form, shapes, 32, 2, RADIUS)
                  if x.kernel == kernel and x.boxes[0] != (0, 0))
    bad = dataclasses.replace(launch, boxes=((1, 257),) + launch.boxes[1:])
    out = torch.zeros(batch, value.shape[1], 256, device=device)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="tensor map"):
        forms.launch_cuda(bad, value, shapes, off, att, out, RADIUS)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == before and not out.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["pair", "rows", "qlevel"])
def test_window_d32_bodies_nan_and_inf_offsets(device, form, dtype):
    """NaN and +-inf offsets, exactly +-R, 0 and -0, and offsets landing on
    pixel -1, through the D = 32 bodies of K6, K7 (+ K6) and K8: what K1's
    window entry gives, bit for bit."""
    shapes = ((32, 32), (16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(23)
    off = torch.from_numpy(_window_edge_offsets(shapes, 2, s, 8, RADIUS, 0, seed=24)).to(device)
    att = torch.from_numpy(rng.rand(2, s, 8, 4, 4).astype(np.float32)).to(device, dtype)
    value = torch.from_numpy(rng.randn(2, s, 8, 32).astype(np.float32)).to(device, dtype)
    got = window_form_cuda(form, value, shapes, off, att, RADIUS, body="d32")
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, msda_fwd_window_cuda(value, shapes, off, att, RADIUS))


@pytest.mark.parametrize("flag,kernel", [("FUSED", "msda_fwd_qlevel"), ("V6", "msda_fwd_dense")])
def test_window_form_flags_route_forward_and_keep_the_backward(device, monkeypatch, flag, kernel):
    """Under FUSED (K8) or V6 (K9 + K1, 8 heads) the encoder's window forward
    launches the form's kernels, the backward stays K2, and the output and
    gradients are K1's."""
    shapes = ((128, 128), (64, 64), (32, 32))
    value, off, att = window_inputs(torch.Generator().manual_seed(6), shapes, 1, "ring",
                                    torch.float32, device)
    grad = torch.randn(1, value.shape[1], 256, device=device)
    results = {}
    for on in (False, True):
        monkeypatch.setattr(msda_dispatch, flag, on)
        _build.reset_launches()
        v, o = value.clone().requires_grad_(), off.clone().requires_grad_()
        out = ms_deform_attn_window(v, shapes, o, att, RADIUS)
        out.backward(grad)
        results[on] = (out.detach(), v.grad, o.grad)
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        assert launches.get("msda_bwd") == 1
        assert (launches.get(kernel, 0) > 0) == on
    for got, want in zip(results[True], results[False]):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) < 1e-5 * scale


def test_window_form_refuses_bad_inputs(device):
    shapes = ((16, 16), (8, 8))
    value, off, att = window_inputs(torch.Generator().manual_seed(7), shapes, 1, "ring",
                                    torch.float32, device)
    with pytest.raises(TypeError):
        window_form_cuda("qlevel", value.half(), shapes, off, att.half(), RADIUS)
    with pytest.raises(ValueError, match="contiguous"):
        strided = off.transpose(-1, -2).contiguous().transpose(-1, -2)
        window_form_cuda("qlevel", value, shapes, strided, att, RADIUS)
    wide = torch.zeros(1, value.shape[1], 4, 64, device=device)
    with pytest.raises(ValueError, match="head width"):
        window_form_cuda("pair", wide, shapes, off[:, :, :4].contiguous(),
                         att[:, :, :4].contiguous(), RADIUS)


# K10's pairs (experiments/pair_probe.py) at a quarter of their sides
PROBE_PAIRS = {name: tuple(n // 4 for n in g) for name, g in k10.PAIRS.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", sorted(PROBE_PAIRS))
@pytest.mark.parametrize("variant", k10.VARIANTS)
def test_pair_probe_variants_match_plain(device, variant, pair, dtype):
    """Every K10 variant against its plain version (f32 outputs of the same
    inputs; bf16fma's rounds as the kernel's bf16 blend), and base against
    K1 on the pair, bit for bit in the value's dtype."""
    hq, wq, hv, wv = PROBE_PAIRS[pair]
    value, _, loc, att = pair_inputs(hq, wq, hv, wv, device, dtype)
    got = k10.pair_probe_cuda(variant, value, loc, att, hv, wv)
    want = k10.pair_probe_plain(variant, value, loc, att, hv, wv)
    assert got.dtype == torch.float32 and got.shape == (1, hq * wq, 256)
    assert float((got - want).abs().max()) <= PROBE_BOUND
    if variant == "base":
        _assert_base_is_k1(got, value, loc, att, hv, wv)


def _assert_base_is_k1(got, value, loc, att, hv: int, wv: int):
    """K10 base equals K1 on the pair: rounded to the value's dtype, bit for
    bit; and with the value in f32, its f32 output exactly."""
    shapes, loc1, att1 = ((hv, wv),), loc[:, :, :, None], att[:, :, :, None]
    k1 = msda_fwd_cuda(value, shapes, loc1, att1)
    assert torch.equal(got.to(value.dtype).view(k1.shape), k1)
    value32 = value.float()
    k1_32 = msda_fwd_cuda(value32, shapes, loc1, att1)
    assert torch.equal(k10.pair_probe_cuda("base", value32, loc, att, hv, wv).view(k1_32.shape),
                       k1_32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("points", [3, 9])
@pytest.mark.parametrize("variant", k10.VARIANTS)
def test_pair_probe_variants_on_a_ragged_launch(device, variant, points, dtype):
    """Every K10 variant against its plain version where the items (37
    queries x 3 heads) fill no whole block nor warp, so the last warp's
    empty items take part in the shuffles; P = 3 leaves lanes of an item
    without a sample and P = 9 takes two rounds of 8. base equals K1."""
    rng = np.random.RandomState(5)
    q, heads, hv, wv = 37, 3, 5, 7
    value = torch.from_numpy(rng.randn(1, hv * wv, heads, 32).astype(np.float32)).to(device, dtype)
    loc = torch.from_numpy(rng.uniform(-0.15, 1.15, (1, q, heads, points, 2)).astype(np.float32))
    att = torch.from_numpy(rng.rand(1, q, heads, points).astype(np.float32))
    loc, att = loc.to(device), att.to(device)
    got = k10.pair_probe_cuda(variant, value, loc, att, hv, wv)
    want = k10.pair_probe_plain(variant, value, loc, att, hv, wv)
    assert got.dtype == torch.float32 and got.shape == (1, q, heads * 32)
    assert float((got - want).abs().max()) <= PROBE_BOUND
    if variant == "base":
        _assert_base_is_k1(got, value, loc, att, hv, wv)


def test_pair_probe_refuses_unaligned_inputs(device):
    """The 8-lane body reads a corner's 4 channels in one 8- or 16-byte
    load: a value that does not start 16-byte aligned is refused unlaunched."""
    value, _, loc, att = pair_inputs(4, 4, 4, 4, device, torch.float32)
    shifted = torch.empty(value.numel() + 1, device=device)[1:].view(value.shape)
    shifted.copy_(value)
    before = _build.LAUNCHES["msda_pair_probe"]
    with pytest.raises(ValueError, match="16-byte"):
        k10.pair_probe_cuda("base", shifted, loc, att, 4, 4)
    assert _build.LAUNCHES["msda_pair_probe"] == before


def test_pair_probe_bf16fma_rounds_once_a_corner(device):
    """A sample whose corner 01 times its weight lies halfway between two
    bf16 values, after a corner 00 of 1e-30: __hfma2 rounds the exact sum
    once, up; a sum rounded to f32 first would land on the tie and round
    down. The kernel equals the plain version's single rounding."""
    value = torch.tensor([1e-30, 1 + 3 / 128, 0.0, 0.0], device=device)
    value = value.view(1, 4, 1, 1).expand(1, 4, 1, 32).to(torch.bfloat16).contiguous()
    loc = torch.tensor([0.625, 0.25], device=device).view(1, 1, 1, 1, 2)
    att = torch.ones(1, 1, 1, 1, device=device)
    got = k10.pair_probe_cuda("bf16fma", value, loc, att, 2, 2)
    assert torch.equal(got, k10.pair_probe_plain("bf16fma", value, loc, att, 2, 2))
    assert torch.equal(got, torch.full_like(got, 0.76953125))  # 0.75 * (1 + 3/128) rounded up


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("n,dh", ATTN_SIZES)
def test_attention_tiles_match_plain_and_k5(device, tile, dtype, n, dh):
    """Every K11 tile against the plain attention, and (64, 64) against K5
    bit for bit; a tile that does not fit a block is refused unlaunched."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, n, dh).astype(np.float32)).to(device, dtype)
               for _ in range(3))
    if not attn_tile_fits(*tile, dh, dtype):
        before = _build.LAUNCHES["attn_fwd_tiles"]
        with pytest.raises(ValueError, match="shared memory"):
            attn_fwd_tiles_cuda(q, k, v, dh**-0.5, *tile)
        assert _build.LAUNCHES["attn_fwd_tiles"] == before
        return
    got = attn_fwd_tiles_cuda(q, k, v, dh**-0.5, *tile)
    want = global_attention_plain(q.float(), k.float(), v.float(), dh**-0.5)
    assert got.dtype == dtype and float((got.float() - want).abs().max()) < TOL[dtype]
    if tile == (64, 64):
        assert torch.equal(got, attn_fwd_cuda(q, k, v, dh**-0.5))
