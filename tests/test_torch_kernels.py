"""The port's CUDA kernels against their plain versions on an NVIDIA card.

These tests (forward and backward kernels, the merged and the split MSDA
backward, the encoder's other window forward forms K6-K9, the probes K10
and K11) need a CUDA device and the CUDA toolkit: the kernels have no CPU
mode, so without a card they skip. The file imports neither JAX nor the
test conftest, so it runs on a machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q
"""

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
from ape_tpu_torch.ops.msda import ms_deform_attn
from ape_tpu_torch.ops.msda_dispatch import (
    ms_deform_attn_exact,
    ms_deform_attn_window,
    msda_bwd_cuda,
    msda_bwd_offatt_cuda,
    msda_bwd_value_cuda,
    msda_fwd_cuda,
    window_locations,
)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_split_backward_kernels_match_autograd_and_merged(device, dtype):
    """K3 (d_loc, d_att) and K4 (d_value) against autograd of the plain
    version and against K2 on the same inputs."""
    shapes, value, loc, att, grad = _msda_grad_inputs(device, dtype)
    d_loc, d_att = msda_bwd_offatt_cuda(value, shapes, loc, att, grad)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
@pytest.mark.parametrize("form", ["pair", "rows", "qlevel", "dense"])
def test_window_form_kernels_match_plain_and_k1(device, form, pyramid, dtype):
    """K6 (all pairs), K7 (+ K6), K8 and K9 (+ K1) as the whole window op at
    the protocol pyramid (batch 1) and the 4-scale one (batch 2), radius 4,
    against the plain version and against K1 on the same inputs."""
    shapes, batch = PYRAMIDS[pyramid]
    value, off, att = window_inputs(torch.Generator().manual_seed(5), shapes, batch, "ring", dtype,
                                    device)
    got = window_form_cuda(form, value, shapes, off, att, RADIUS)
    assert got.dtype == dtype and got.shape == (batch, value.shape[1], 256)
    plain = window_plain(value, shapes, off, att, RADIUS)
    k1 = msda_fwd_cuda(value, shapes, window_locations(shapes, off, RADIUS).contiguous(), att)
    assert float((got.float() - plain.float()).abs().max()) < TOL[dtype]
    assert float((got.float() - k1.float()).abs().max()) < TOL[dtype]


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
        k1 = msda_fwd_cuda(value, ((hv, wv),), loc[:, :, :, None], att[:, :, :, None])
        assert torch.equal(got.to(dtype).view(k1.shape), k1)


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
