"""K9's D = 32 body (csrc/msda_fwd_dense.cu msda_fwd_dense_kernel_d32) on the
CPU: its plan and shared-memory layout, and its arithmetic emulated in torch
against the plain window op and against JAX's exact window path.

The kernel builds, for each query tile of at most 32 queries and each staged
value level, a weight matrix W (tile rows x box pixels, f32) from K1's corner
weights, splits it into bf16 halves hi = bf16(W), lo = bf16(W - hi), and adds
hi V + lo V on the tensor cores with V the bf16 box, in f32; finer levels are
sampled from device memory. The emulation below repeats that tile by tile
(boxes, the rows each m16 block stages, W, the split, f32 products), so the
card's check that K9 stays within 2e-4 of the f32 plain version has a CPU
counterpart that shows the split is what keeps it there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import cap_torch_threads  # noqa: F401 (caps torch threads a worker)

from ape_tpu.ops.msda_dispatch import ms_deform_attn_window_dispatch
from ape_tpu_torch.ops import msda_window_forms as forms
from ape_tpu_torch.ops.msda import level_start_index

PROTOCOL = ((128, 128), (64, 64), (32, 32), (16, 16), (8, 8))
FOUR_SCALE = ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16))
PYRAMIDS = {"protocol": PROTOCOL, "four_scale": FOUR_SCALE}
SMEM_PER_SM = 233472  # an H100 SM's 228 KB, of which each block also takes 1 KB
# The emulation against the f32 plain version over its largest output: the
# split keeps about 2^-16 of each weight; without lo it reads about 2^-9.
EMULATION_BOUND = 5e-5
WITHOUT_LO_ABOVE = 1e-4


@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_dense_d32_plan_fits_and_keeps_the_launches(pyramid):
    """In bf16 at head width 32 every K9 launch takes the D = 32 body, a tile
    of at most 32 queries, and shared memory that leaves room for 2 or more
    blocks an SM; the launches per layer are those of the general body's
    plan (chip_smoke.with_form counts on them)."""
    shapes = PYRAMIDS[pyramid]
    plan = forms.plan_layer("dense", shapes, 32, 2, 4)
    general = forms.plan_layer("dense", shapes, 32, 2, 4, body="general")
    assert forms.launches_per_layer(plan) == forms.launches_per_layer(general)
    assert [x.query_levels for x in plan] == [x.query_levels for x in general]
    dense = [x for x in plan if x.kernel == "msda_fwd_dense"]
    assert dense and all(x.body == "d32" for x in dense)
    for x in dense:
        assert x.tile[0] * x.tile[1] <= forms.DENSE_D32_ROWS
        assert x.smem <= forms.SMEM_LIMIT and 2 * (x.smem + 1024) <= SMEM_PER_SM
        for lv, box in zip(x.value_levels, x.boxes):
            assert (box == (0, 0)) == forms.finer(shapes[x.query_levels[0]], shapes[lv])


def test_dense_d32_body_only_for_bf16_at_width_32():
    for esize, head_dim, want in ((2, 32, "d32"), (4, 32, "general"), (2, 16, "general"),
                                  (4, 8, "general")):
        assert forms.dense_body(head_dim, esize) == want
        bodies = {x.body for x in forms.plan_layer("dense", PROTOCOL, head_dim, esize, 4)
                  if x.kernel == "msda_fwd_dense"}
        assert bodies == {want}
    with pytest.raises(ValueError, match="no body"):
        forms.plan_layer("dense", PROTOCOL, 32, 4, 4, body="d32")
    with pytest.raises(ValueError, match="no body"):
        forms.plan_layer("dense", PROTOCOL, 16, 2, 4, body="d32")


@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_dense_d32_layout_is_the_kernels(pyramid):
    """The planner's shared memory is the kernel's dense_layout: the f32 out
    tile (32 rows of 40 floats), W (32 rows of a stride of 8 mod 32 floats,
    so that a half-warp's A-fragment float2 loads hit 32 distinct banks),
    one box of the largest staged level, 64 bytes a pixel, padded to 16
    pixels (k-steps of 16), at a 1024-byte aligned offset (its rows swizzled
    as the TMA writes them), and the box's mbarrier."""
    shapes = PYRAMIDS[pyramid]
    for x in forms.plan_layer("dense", shapes, 32, 2, 4):
        if x.kernel != "msda_fwd_dense":
            continue
        k_max = max(-(-h * w // 16) * 16 for h, w in x.boxes if h)
        stride = -(-k_max // 32) * 32 + 8
        assert stride % 32 == 8
        banks = {(8 * g + 2 * t + e) % 32 for g in range(4) for t in range(4) for e in range(2)}
        assert len(banks) == 32
        box_at = -(-(32 * 40 * 4 + 32 * stride * 4) // 1024) * 1024
        assert x.smem == box_at + k_max * 64 + 16


# ---- the emulation ---------------------------------------------------------


def _f32(x):
    return np.float32(x)


def _center(q, n):
    return _f32(_f32(q + 0.5) / _f32(n))


def _window_base(q, nq, nv, win):
    """csrc/msda_window.cuh's window_base in f32."""
    c = _f32(_f32(_center(q, nq) * _f32(nv)) - _f32(0.5))
    return int(np.floor(_f32(c + _f32(0.5)))) - (win - 3) // 2 - 1


def _sample_pixel(c, o, r, size):
    """msda_window.cuh's sample_pixel in f32: NaN kept, +-inf clipped."""
    clipped = np.where(np.isnan(o), o, np.clip(o, -r, r)).astype(np.float32)
    loc = (c + clipped / _f32(size)).astype(np.float32)
    return (loc * _f32(size)).astype(np.float32) - _f32(0.5)


def emulate_dense_d32(value, shapes, off, att, radius, launch, split=True):
    """One launch of K9's D = 32 body, tile by tile, in torch: value (B, S,
    H, 32) bf16, off (B, S, H, L, P, 2) f32, att (B, S, H, L, P) -> the
    query level's rows (B, hq * wq, H * 32) f32, and the count of corners
    that fell outside their m16 block's staged rows (the kernel drops those,
    as here: band() in the kernel and the sweep below show there are none)."""
    (lq,) = launch.query_levels
    hq, wq = shapes[lq]
    ty, tx = launch.tile
    starts, _ = level_start_index(shapes)
    win = forms.window_taps(radius)
    b, _, h, d = value.shape
    v32 = value.float()
    off_np, att_np = off.numpy(), att.float().numpy()
    out = torch.zeros(b, hq * wq, h, d)
    outside = 0
    for qy0 in range(0, hq, ty):
        for qx0 in range(0, wq, tx):
            ny, nx = min(ty, hq - qy0), min(tx, wq - qx0)
            n = ny * nx
            qy = qy0 + np.arange(n) // nx
            qx = qx0 + np.arange(n) % nx
            rows = starts[lq] + qy * wq + qx
            cx = np.array([_center(q, wq) for q in qx], np.float32)[None, :, None, None]
            cy = np.array([_center(q, hq) for q in qy], np.float32)[None, :, None, None]
            acc = torch.zeros(b, n, h, d)
            for j, lv in enumerate(launch.value_levels):
                hl, wl = shapes[lv]
                lvl = v32[:, starts[lv]:starts[lv] + hl * wl]  # (B, hl * wl, H, D)
                o = off_np[:, :, :, lv][:, rows]  # (B, n, H, P, 2)
                a = att_np[:, :, :, lv][:, rows]
                with np.errstate(invalid="ignore"):
                    x = _sample_pixel(cx, o[..., 0], radius, wl)
                    y = _sample_pixel(cy, o[..., 1], radius, hl)
                    live = (x > -1) & (y > -1) & (x < wl) & (y < hl)
                x, y = np.where(live, x, 0), np.where(live, y, 0)
                x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
                fx, fy = (x - x0).astype(np.float32), (y - y0).astype(np.float32)
                staged = not forms.finer(shapes[lq], shapes[lv])
                if staged:
                    bh, bw = launch.boxes[j]
                    by0 = _window_base(qy0, hq, hl, win)
                    bx0 = _window_base(qx0, wq, wl, win)
                    band = {}
                    for m in range(2):
                        if 16 * m < n:
                            i0, i1 = 16 * m, min(16 * m + 15, n - 1)
                            lo = max(_window_base(qy0 + i0 // nx, hq, hl, win) - by0, 0)
                            hi = min(_window_base(qy0 + i1 // nx, hq, hl, win) - by0 + win, bh)
                            band[m] = (lo, hi)
                    w_mat = torch.zeros(b, h, n, bh * bw)
                for dy in (0, 1):
                    for dx in (0, 1):
                        yy, xx = y0 + dy, x0 + dx
                        w = ((fx if dx else _f32(1) - fx) * (fy if dy else _f32(1) - fy))
                        aw = (a * w.astype(np.float32)).astype(np.float32)
                        inside = live & (yy >= 0) & (yy < hl) & (xx >= 0) & (xx < wl)
                        ry, rx = yy - by0 if staged else yy, xx - bx0 if staged else xx
                        in_band = np.zeros_like(inside)
                        if staged:
                            lo_hi = np.array([band[i // 16] for i in range(n)])
                            lo = lo_hi[:, 0][None, :, None, None]
                            hi = lo_hi[:, 1][None, :, None, None]
                            in_band = inside & (ry >= lo) & (ry < hi) & (rx >= 0) & (rx < bw)
                        outside += int((inside & ~in_band).sum()) if staged else 0
                        # corners read from device memory: the finer levels'
                        direct = np.zeros_like(inside) if staged else inside
                        pix = np.where(direct, yy * wl + xx, 0)
                        vals = torch.gather(
                            lvl.permute(0, 2, 1, 3), 2,
                            torch.from_numpy(pix).permute(0, 2, 1, 3).reshape(b, h, -1, 1)
                            .expand(-1, -1, -1, d)).reshape(b, h, n, -1, d)
                        coef = torch.from_numpy(np.where(direct, aw, 0)).permute(0, 2, 1, 3)
                        acc += (coef[..., None] * vals).sum(3).permute(0, 2, 1, 3)
                        if staged:
                            kidx = torch.from_numpy(np.where(in_band, ry * bw + rx, 0))
                            src = torch.from_numpy(np.where(in_band, aw, 0))
                            w_mat.scatter_add_(3, kidx.permute(0, 2, 1, 3),
                                               src.permute(0, 2, 1, 3))
                if staged:
                    by = by0 + np.arange(bh * bw) // bw
                    bx = bx0 + np.arange(bh * bw) % bw
                    ok = (by >= 0) & (by < hl) & (bx >= 0) & (bx < wl)
                    box = torch.zeros(b, bh * bw, h, d)
                    box[:, ok] = lvl[:, (by * wl + bx)[ok]]
                    box = box.permute(0, 2, 1, 3)  # (B, H, k, D): bf16 values, exact in f32
                    w_hi = w_mat.bfloat16().float()
                    prod = w_hi @ box
                    if split:
                        prod = prod + (w_mat - w_hi).bfloat16().float() @ box
                    acc += prod.permute(0, 2, 1, 3)
            out[:, qy * wq + qx] = acc
    return out.reshape(b, hq * wq, h * d), outside


def _inputs(rng, shapes, b=1, heads=2, p=4, max_off=6.0):
    """Seeded inputs: a bf16 value, offsets past the radius (so the clip
    bites) with NaN, +-inf, exactly +-R and 0 among them, softmax weights."""
    s = sum(hh * ww for hh, ww in shapes)
    value = torch.from_numpy(rng.randn(b, s, heads, 32).astype(np.float32)).bfloat16()
    off = rng.uniform(-max_off, max_off, (b, s, heads, len(shapes), p, 2)).astype(np.float32)
    flat = off.reshape(-1)
    edges = np.array([np.nan, np.inf, -np.inf, 4.0, -4.0, 0.0], np.float32)
    flat[rng.choice(flat.size, 6 * 16, replace=False)] = np.tile(edges, 16)
    att = rng.rand(b, s, heads, len(shapes) * p).astype(np.float32)
    att = np.exp(att) / np.exp(att).sum(-1, keepdims=True)
    return value, torch.from_numpy(off), torch.from_numpy(att.reshape(b, s, heads, -1, p))


def _axis_corners_in_band(launch, shapes, radius, axis, offsets):
    """Along one axis (0: rows, 1: columns), every query of a K9 launch's
    query level at every offset: the corners floor(p), floor(p) + 1 of its
    sample pixel p that lie on the level, each against what the kernel
    stages for it (band(): the rows its m16 block's windows span, clipped to
    the box; columns: the box's). Returns the count outside."""
    (lq,) = launch.query_levels
    hq, wq = shapes[lq]
    ty, tx = launch.tile
    win = forms.window_taps(radius)
    missed = 0
    for lv, box in zip(launch.value_levels, launch.boxes):
        if forms.finer(shapes[lq], shapes[lv]):
            continue
        hl, wl = shapes[lv]
        nv, nq = (hl, hq) if axis == 0 else (wl, wq)
        # (query's place on the axis, first and last staged pixel) per query
        spans = set()
        for q0 in range(0, hq, ty):
            for x0 in range(0, wq, tx):
                ny, nx = min(ty, hq - q0), min(tx, wq - x0)
                n = ny * nx
                if axis == 1:
                    base = _window_base(x0, wq, wl, win)
                    spans.update((x0 + i, base, base + box[1]) for i in range(nx))
                    continue
                y0 = _window_base(q0, hq, hl, win)
                for m in range(0, n, 16):
                    i1 = min(m + 15, n - 1)
                    lo = max(_window_base(q0 + m // nx, hq, hl, win) - y0, 0)
                    hi = min(_window_base(q0 + i1 // nx, hq, hl, win) - y0 + win, box[0])
                    spans.update((q0 + i // nx, y0 + lo, y0 + hi) for i in range(m, i1 + 1))
        q, first, end = (np.array(v)[:, None] for v in zip(*sorted(spans)))
        with np.errstate(invalid="ignore"):
            pos = _sample_pixel(np.array([_center(int(v), nq) for v in q[:, 0]],
                                         np.float32)[:, None], offsets[None, :], radius, nv)
        live = (pos > -1) & (pos < nv)
        low = np.floor(np.where(live, pos, 0)).astype(int)
        for c in (low, low + 1):
            on_level = live & (c >= 0) & (c < nv)
            missed += int((on_level & ((c < first) | (c >= end))).sum())
    return missed


@pytest.mark.parametrize("radius", [4, 2.5])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_dense_d32_corners_stay_in_their_blocks_rows(pyramid, radius):
    """Every corner a K9 launch's queries can reach on a staged level lies in
    the rows the kernel stages for the query's m16 block and in the box's
    columns, over every query of the planned tiles at both pyramids, for
    offsets +-R, one f32 step inside and outside +-R, +-inf, 0, -0, NaN
    and a fine grid over [-R - 1, R + 1]: the kernel, which drops a corner
    outside them, drops none."""
    shapes = PYRAMIDS[pyramid]
    r = np.float32(radius)
    offsets = np.concatenate([
        np.array([r, -r, np.nextafter(r, np.float32(0)), np.nextafter(-r, np.float32(0)),
                  np.nextafter(r, np.float32(np.inf)), np.nextafter(-r, np.float32(-np.inf)),
                  np.inf, -np.inf, 0.0, -0.0, np.nan], np.float32),
        np.linspace(-r - 1, r + 1, 1001, dtype=np.float32)])
    launches = [x for x in forms.plan_layer("dense", shapes, 32, 2, radius)
                if x.kernel == "msda_fwd_dense"]
    assert launches and all(x.body == "d32" for x in launches)
    for x in launches:
        for axis in (0, 1):
            assert _axis_corners_in_band(x, shapes, radius, axis, offsets) == 0, (x, axis)


# A 128-wide query level reading only same-or-coarser levels, and one (4 x
# 128) reading a finer level (8 x 256), as the 4-scale pyramid's 128^2 level
# reads its 256^2 one; both narrow levels go to K1.
SMALL = {"coarser": ((4, 128), (2, 64), (1, 32)), "finer": ((8, 256), (4, 128), (2, 64))}


def _emulated_rows(value, shapes, off, att, split=True):
    """{rows of a K9 launch: its emulated output} over the bf16 plan's K9
    launches, and the corners read from device memory in all."""
    starts, _ = level_start_index(shapes)
    rows, outside = {}, 0
    for x in forms.plan_layer("dense", shapes, 32, 2, 4):
        if x.kernel != "msda_fwd_dense":
            continue
        assert x.body == "d32"
        (lq,) = x.query_levels
        got, n_out = emulate_dense_d32(value, shapes, off, att, 4, x, split)
        rows[slice(starts[lq], starts[lq] + shapes[lq][0] * shapes[lq][1])] = got
        outside += n_out
    return rows, outside


@pytest.mark.parametrize("geometry", sorted(SMALL))
def test_dense_d32_emulation_matches_plain_and_jax(rng, geometry):
    """The emulated contraction within 5e-5 of the largest output of the
    plain version (on the bf16 value upcast to f32) and of JAX's exact
    window path on the same numpy inputs; every staged corner lands in its
    m16 block's rows, so the kernel reads none from device memory. JAX's
    exact path makes a (b, q, h) with a NaN offset NaN, where the port drops
    the sample (ROADMAP Queue 3, trait 7): those rows are compared with the
    plain version only."""
    shapes = SMALL[geometry]
    value, off, att = _inputs(rng, shapes)
    rows, outside = _emulated_rows(value, shapes, off, att)
    assert outside == 0
    plain = forms.window_plain(value.float(), shapes, off, att, 4)
    jax_out = np.asarray(ms_deform_attn_window_dispatch(
        jnp.asarray(value.float().numpy()), shapes, jnp.asarray(off.numpy()),
        jnp.asarray(att.numpy()), radius=4, force_impl="exact"))
    for sl, got in rows.items():
        jax_rows = torch.from_numpy(np.array(jax_out[:, sl]))
        finite = torch.isfinite(jax_rows)
        assert finite.float().mean() > 0.9
        for name, want, keep in (("plain", plain[:, sl], torch.ones_like(finite)),
                                 ("jax", jax_rows, finite)):
            scale = float(want[keep].abs().max())
            err = float((got - want)[keep].abs().max())
            assert err <= EMULATION_BOUND * scale, (name, err / scale)


@pytest.mark.parametrize("geometry", sorted(SMALL))
def test_dense_d32_emulation_without_lo_misses_the_bound(rng, geometry):
    """Without W's low half the same emulation lands above 1e-4 of the
    largest output: the card's 2e-4 check of the f32 out mode catches a
    kernel that drops it."""
    shapes = SMALL[geometry]
    value, off, att = _inputs(rng, shapes)
    rows, _ = _emulated_rows(value, shapes, off, att, split=False)
    plain = forms.window_plain(value.float(), shapes, off, att, 4)
    worst = max(float((got - plain[:, sl]).abs().max()) / float(plain[:, sl].abs().max())
                for sl, got in rows.items())
    assert worst > WITHOUT_LO_ABOVE


def test_run_plan_with_the_d32_body_gives_the_window_op(rng):
    """The wrappers' plumbing with the D = 32 body's launches emulated: K9's
    rows stored in the value's dtype, K1's runs beside them, give the plain
    whole op within one bf16 step of its largest output."""
    from ape_tpu_torch.ops.msda import ms_deform_attn

    shapes = SMALL["finer"]
    value, off, att = _inputs(rng, shapes)
    att = att.bfloat16()
    starts, _ = level_start_index(shapes)

    def launch(x, value, shapes, off, att, out, radius):
        (lq,) = x.query_levels
        rows = slice(starts[lq], starts[lq] + shapes[lq][0] * shapes[lq][1])
        out[:, rows] = emulate_dense_d32(value, shapes, off, att, radius, x)[0].to(out.dtype)

    plan = forms.plan_layer("dense", shapes, 32, 2, 4)
    assert [x.kernel for x in plan] == ["msda_fwd_dense", "msda_fwd_dense", "msda_fwd"]
    got = forms.run_plan(plan, value, shapes, off, att, 4, launch, ms_deform_attn)
    want = forms.window_plain(value, shapes, off, att, 4)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= 2 ** -7 * float(
        want.float().abs().max())
