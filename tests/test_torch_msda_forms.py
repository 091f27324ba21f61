"""The encoder's window-MSDA forward forms of the port (ops/msda_window_forms.py,
the flags of ops/msda_dispatch.py) against ape_tpu on the CPU, in f32.

The CUDA kernels (K6-K9) run only on a card (tests/test_torch_kernels.py);
here their plain versions are held to JAX's XLA window oracle, the one that
JAX's own kernel tests hold K6-K9 to, and the plans that decide each form's
launches are checked with no card. The interpret-mode comparisons with the
TPU kernels themselves are marked slow, as the JAX package marks its own.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.parity_harness import DIMS
from tests.torch_parity import tiny_inputs, torch_tiny_protocol

from ape_tpu.ops.msda_window import ms_deform_attn_window as jax_window
from ape_tpu.ops.msda_window import xla_pair
from ape_tpu_torch.engine.train_step import loss_fn
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from ape_tpu_torch.ops import msda_dispatch
from ape_tpu_torch.ops import msda_window_forms as forms
from ape_tpu_torch.ops.msda import level_start_index

TOL = 1e-5  # f32; the two sides round the bilinear weights in other orders
PROTOCOL = ((128, 128), (64, 64), (32, 32), (16, 16), (8, 8))
FOUR_SCALE = ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16))


def _inputs(rng, shapes, b=1, heads=2, d=8, p=2, max_off=6.0):
    """Seeded numpy inputs as tests/test_msda_pallas.py draws them: offsets
    beyond the radius, so the clip bites."""
    s = sum(h * w for h, w in shapes)
    value = rng.randn(b, s, heads, d).astype(np.float32)
    off = rng.uniform(-max_off, max_off, size=(b, s, heads, len(shapes), p, 2)).astype(np.float32)
    att = rng.rand(b, s, heads, len(shapes), p).astype(np.float32)
    att /= att.reshape(b, s, heads, -1).sum(-1)[..., None, None]
    return value, off, att


# (query level, value level): same size, value coarser by 2 and 4 (inv2,
# inv4), value finer by 2 and 4 (sx2, sx4)
PAIRS = {"same": ((8, 8), (8, 8)), "inv2": ((16, 16), (8, 8)), "inv4": ((16, 16), (4, 4)),
         "sx2": ((8, 8), (16, 16)), "sx4": ((4, 4), (16, 16))}


@pytest.mark.parametrize("radius", [2, 4])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_pair_plain_matches_xla_pair(rng, pair, radius):
    (hq, wq), (hv, wv) = PAIRS[pair]
    b, h, d, p = 2, 3, 8, 4
    value = rng.randn(b, hv * wv, h, d).astype(np.float32)
    off = rng.uniform(-radius - 2, radius + 2, (b, hq * wq, h, p, 2)).astype(np.float32)
    att = rng.rand(b, hq * wq, h, p).astype(np.float32)
    want = xla_pair(jnp.asarray(value.reshape(b, hv, wv, h, d)),
                    jnp.clip(jnp.asarray(off), -radius, radius).reshape(b, hq, wq, h, p, 2),
                    jnp.asarray(att.reshape(b, hq, wq, h, p)), hq, wq, hv, wv, radius)
    got = forms.window_pair_plain(torch.from_numpy(value), torch.from_numpy(off),
                                  torch.from_numpy(att), hq, wq, hv, wv, radius)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq * wq, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(b, hq * wq, h * d),
                               rtol=0, atol=TOL)


# the pyramids of tests/test_msda_pallas.py (geometry coverage), and a
# non-square one
PYRAMIDS = {"three": (((16, 16), (8, 8), (4, 4)), 2), "one_r4": (((16, 16),), 4),
            "extreme": (((32, 32), (4, 4), (2, 2)), 2), "oblong": (((8, 16), (4, 8)), 4)}


@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_qlevel_plain_sums_to_window_oracle(rng, pyramid):
    """Each query level's plain rows (the sum of its pairs), and their
    concatenation, against JAX's ms_deform_attn_window."""
    shapes, radius = PYRAMIDS[pyramid]
    value, off, att = _inputs(rng, shapes, b=2, heads=2, d=8, p=2)
    want = np.asarray(jax_window(jnp.asarray(value), shapes, jnp.asarray(off), jnp.asarray(att),
                                 radius=radius))
    starts, _ = level_start_index(shapes)
    rows = [forms.window_qlevel_plain(torch.from_numpy(value), shapes, lq, torch.from_numpy(off),
                                      torch.from_numpy(att), radius) for lq in range(len(shapes))]
    for lq, (start, got) in enumerate(zip(starts, rows)):
        np.testing.assert_allclose(got.numpy(), want[:, start:start + got.shape[1]], rtol=0,
                                   atol=TOL, err_msg=f"query level {lq}")
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), want, rtol=0, atol=TOL)
    whole = forms.window_plain(torch.from_numpy(value), shapes, torch.from_numpy(off),
                               torch.from_numpy(att), radius)
    np.testing.assert_allclose(whole.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("fused,v6", [(False, False), (True, False), (False, True), (True, True)])
def test_window_op_under_each_flag_on_cpu(rng, monkeypatch, fused, v6):
    """ms_deform_attn_window on CPU tensors under FUSED, V6, both or neither:
    the plain version every time, equal to the default form and to JAX's
    oracle on the same seeded inputs."""
    shapes, radius = (((16, 16), (8, 8), (4, 4)), 2)
    value, off, att = (torch.from_numpy(x) for x in _inputs(rng, shapes, heads=8, d=8, p=2))
    default = msda_dispatch.ms_deform_attn_window(value, shapes, off, att, radius)
    monkeypatch.setattr(msda_dispatch, "FUSED", fused)
    monkeypatch.setattr(msda_dispatch, "V6", v6)
    got = msda_dispatch.ms_deform_attn_window(value, shapes, off, att, radius)
    assert torch.equal(got, default)
    want = jax_window(jnp.asarray(value.numpy()), shapes, jnp.asarray(off.numpy()),
                      jnp.asarray(att.numpy()), radius=radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("fused,v6,heads,form", [
    (False, False, 8, "gather"), (True, False, 8, "qlevel"), (False, True, 8, "dense"),
    (True, True, 8, "qlevel"), (False, True, 4, "gather"), (True, True, 4, "qlevel"),
])
def test_window_form_precedence(monkeypatch, fused, v6, heads, form):
    """JAX's precedence (ape_tpu/ops/msda_dispatch.py:49-60): FUSED first,
    then V6 only with 8 heads, else K1."""
    monkeypatch.setattr(msda_dispatch, "FUSED", fused)
    monkeypatch.setattr(msda_dispatch, "V6", v6)
    assert msda_dispatch.window_form(heads) == form


@pytest.mark.parametrize("env,flags", [({}, (False, False)), ({"APE_MSDA_FUSED": "1"}, (True, False)),
                                       ({"APE_MSDA_V6": "1", "APE_MSDA_FUSED": "0"}, (False, True))])
def test_flags_follow_the_environment(env, flags):
    """The flags start from the environment variables JAX reads."""
    code = ("from ape_tpu_torch.ops import msda_dispatch as m; "
            "print(int(m.FUSED), int(m.V6))")
    base = {k: v for k, v in os.environ.items() if k not in ("APE_MSDA_FUSED", "APE_MSDA_V6")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          env={**base, **env}, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [str(int(f)) for f in flags]


# Launches per layer of each form, head width 32 (APE-Ti), radius 4, for bf16
# and f32 values: K6, K7 and K8 on their D = 32 bodies; K8's holds every box
# of a query level in 227 KB of shared memory, one group a query level (its
# general body groups the f32 64^2 and 32^2 query levels:
# GENERAL_QLEVEL_LAUNCHES); K9 takes the 128-wide query levels, on its D = 32
# body in bf16.
PLANS = {
    ("protocol", 2): {"gather": {"msda_fwd": 1}, "pair": {"msda_fwd_pair": 25},
                      "rows": {"msda_fwd_rows": 5, "msda_fwd_pair": 10},
                      "qlevel": {"msda_fwd_qlevel": 5},
                      "dense": {"msda_fwd_dense": 1, "msda_fwd": 1}},
    ("protocol", 4): {"gather": {"msda_fwd": 1}, "pair": {"msda_fwd_pair": 25},
                      "rows": {"msda_fwd_rows": 5, "msda_fwd_pair": 10},
                      "qlevel": {"msda_fwd_qlevel": 5},
                      "dense": {"msda_fwd_dense": 1, "msda_fwd": 1}},
    ("four_scale", 2): {"gather": {"msda_fwd": 1}, "pair": {"msda_fwd_pair": 25},
                        "rows": {"msda_fwd_rows": 5, "msda_fwd_pair": 10},
                        "qlevel": {"msda_fwd_qlevel": 5},
                        "dense": {"msda_fwd_dense": 2, "msda_fwd": 1}},
    ("four_scale", 4): {"gather": {"msda_fwd": 1}, "pair": {"msda_fwd_pair": 25},
                        "rows": {"msda_fwd_rows": 5, "msda_fwd_pair": 10},
                        "qlevel": {"msda_fwd_qlevel": 5},
                        "dense": {"msda_fwd_dense": 2, "msda_fwd": 1}},
}
SHAPES = {"protocol": PROTOCOL, "four_scale": FOUR_SCALE}


@pytest.mark.parametrize("form", forms.FORMS)
@pytest.mark.parametrize("pyramid,esize", sorted(PLANS))
def test_plan_launches_per_layer(pyramid, esize, form):
    plan = forms.plan_layer(form, SHAPES[pyramid], 32, esize, 4)
    assert forms.launches_per_layer(plan) == PLANS[(pyramid, esize)][form]
    for launch in plan:
        assert launch.smem <= forms.SMEM_LIMIT
        assert launch.tile[0] * launch.tile[1] <= forms.WARPS * 16
        d32 = launch.kernel in ("msda_fwd_pair", "msda_fwd_rows", "msda_fwd_qlevel") or (
            launch.kernel == "msda_fwd_dense" and esize == 2)
        assert launch.body == ("d32" if d32 else "general")


# K8's general body at head width 32: the f32 64^2 and 32^2 query levels
# take two groups each, their boxes and the warps' query windows over 227 KB.
GENERAL_QLEVEL_LAUNCHES = {("protocol", 2): 5, ("protocol", 4): 7, ("four_scale", 2): 5,
                           ("four_scale", 4): 7}


@pytest.mark.parametrize("pyramid,esize", sorted(GENERAL_QLEVEL_LAUNCHES))
def test_general_qlevel_plan_launches_per_layer(pyramid, esize):
    plan = forms.plan_layer("qlevel", SHAPES[pyramid], 32, esize, 4, body="general")
    assert forms.launches_per_layer(plan) == {
        "msda_fwd_qlevel": GENERAL_QLEVEL_LAUNCHES[(pyramid, esize)]}
    assert all(x.body == "general" and x.smem <= forms.SMEM_LIMIT for x in plan)


@pytest.mark.parametrize("pyramid", sorted(SHAPES))
@pytest.mark.parametrize("esize", [2, 4])
def test_d32_plan_stages_aligned_boxes_and_no_windows(pyramid, esize):
    """K8's D = 32 layout: the header, then each same-or-coarser level's box
    at a 128-byte aligned offset (a TMA destination), one after another
    within the launch's shared memory; no region for query windows (a finer
    level is read from device memory), so each launch takes its boxes' bytes
    and no more than the alignment's padding; a tile of at most 64 queries,
    one pass of the body's 16 warps of 4."""
    shapes = SHAPES[pyramid]
    for launch in forms.plan_layer("qlevel", shapes, 32, esize, 4):
        assert launch.tile[0] * launch.tile[1] <= 64
        (lq,) = launch.query_levels
        boxes, offsets, win_off, tap_off, smem = forms._layout(
            launch.kernel, shapes, lq, launch.value_levels, launch.tile, 32, esize,
            forms.window_taps(4), "d32")
        assert boxes == launch.boxes and smem == launch.smem and win_off == tap_off == 0
        staged = [(o * esize, h * w * 32 * esize) for (h, w), o in zip(boxes, offsets)
                  if (h, w) != (0, 0)]
        assert len(staged) == sum(not forms.finer(shapes[lq], shapes[lv])
                                  for lv in launch.value_levels)
        end = forms.D32_HEADER_BYTES
        for at, nbytes in staged:
            assert at % forms.TMA_ALIGN == 0 and end <= at < end + forms.TMA_ALIGN
            end = at + nbytes
        assert smem == end


def test_plan_refuses_a_d32_qlevel_body_at_another_width():
    with pytest.raises(ValueError, match="no body"):
        forms.plan_layer("qlevel", PROTOCOL, 16, 2, 4, body="d32")
    with pytest.raises(ValueError, match="no body"):
        forms.plan_layer("qlevel", PROTOCOL, 32, 2, 4, body="wide")
    assert {x.body for x in forms.plan_layer("qlevel", PROTOCOL, 16, 2, 4)} == {"general"}


@pytest.mark.parametrize("form", ["pair", "rows"])
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("head_dim", [8, 16, 32])
def test_pair_and_rows_take_their_body_by_head_width(form, esize, head_dim):
    """K6 and K7 take their D = 32 bodies at head width 32 and their general
    ones at any other, in both element sizes; a D = 32 plan at another width
    is refused."""
    want = "d32" if head_dim == 32 else "general"
    assert forms.form_body(form, head_dim, esize) == want
    assert {x.body for x in forms.plan_layer(form, PROTOCOL, head_dim, esize, 4)} == {want}
    if head_dim != 32:
        with pytest.raises(ValueError, match="no body"):
            forms.plan_layer(form, PROTOCOL, head_dim, esize, 4, body="d32")


@pytest.mark.parametrize("pyramid", sorted(SHAPES))
@pytest.mark.parametrize("esize", [2, 4])
def test_pair_and_rows_d32_plans(pyramid, esize):
    """K6's and K7's D = 32 plans: the launches per layer of the general
    plans (25; 5 + 10); tiles of at most 64 queries; each K6 box at a
    TMA_ALIGN offset past the header, a finer level unstaged; K7 one launch a
    query level (no group split) over its same-or-coarser levels, its ring
    the header and two TMA_ALIGN-aligned slots of the largest box, level j's
    box in slot j mod 2, within SMEM_LIMIT; the finer pairs before K7, the
    first launch of a query level storing and the others continuing."""
    shapes = SHAPES[pyramid]
    win = forms.window_taps(4)
    for form in ("pair", "rows"):
        plan = forms.plan_layer(form, shapes, 32, esize, 4, body="d32")
        general = forms.plan_layer(form, shapes, 32, esize, 4, body="general")
        assert forms.launches_per_layer(plan) == forms.launches_per_layer(general)
        for lq in range(len(shapes)):
            mine = [x for x in plan if x.query_levels == (lq,)]
            assert [x.out_mode for x in mine] == ["store"] + ["continue"] * (len(mine) - 1)
            assert [lv for x in mine for lv in x.value_levels] == list(range(len(shapes)))
        for x in plan:
            (lq,) = x.query_levels
            assert x.body == "d32" and x.tile[0] * x.tile[1] <= 64 and x.smem <= forms.SMEM_LIMIT
            boxes, offsets, win_off, tap_off, smem = forms._layout(
                x.kernel, shapes, lq, x.value_levels, x.tile, 32, esize, win, "d32")
            assert boxes == x.boxes and smem == x.smem and win_off == tap_off == 0
            sizes = [h * w * 32 * esize for h, w in boxes]
            if x.kernel == "msda_fwd_pair":
                (lv,) = x.value_levels
                if forms.finer(shapes[lq], shapes[lv]):
                    assert boxes == ((0, 0),) and smem == forms.D32_HEADER_BYTES
                    continue
                at = offsets[0] * esize
                assert at % forms.TMA_ALIGN == 0
                assert forms.D32_HEADER_BYTES <= at < forms.D32_HEADER_BYTES + forms.TMA_ALIGN
                assert smem == at + sizes[0]
                continue
            assert not any(forms.finer(shapes[lq], shapes[lv]) for lv in x.value_levels)
            assert sum(y.kernel == "msda_fwd_rows" and y.query_levels == (lq,) for y in plan) == 1
            slot0 = offsets[0] * esize
            slot1 = slot0 + -(-max(sizes) // forms.TMA_ALIGN) * forms.TMA_ALIGN
            assert slot0 % forms.TMA_ALIGN == 0 and slot1 % forms.TMA_ALIGN == 0
            assert forms.D32_HEADER_BYTES <= slot0 < forms.D32_HEADER_BYTES + forms.TMA_ALIGN
            assert [o * esize for o in offsets] == [(slot0, slot1)[j % 2]
                                                    for j in range(len(boxes))]
            assert smem == slot1 + max(sizes) <= forms.SMEM_LIMIT


def test_rows_d32_refuses_levels_out_of_order():
    """K7's D = 32 body takes consecutive value levels; a pyramid whose
    same-or-coarser levels are not consecutive is refused at plan time (its
    general body takes it)."""
    shapes = ((16, 16), (32, 32), (8, 8))
    with pytest.raises(ValueError, match="consecutive"):
        forms.plan_layer("rows", shapes, 32, 2, 4, body="d32")
    assert forms.launches_per_layer(forms.plan_layer("rows", shapes, 32, 2, 4, body="general")) \
        == {"msda_fwd_rows": 3, "msda_fwd_pair": 3}


@pytest.mark.parametrize("pyramid", sorted(SHAPES))
@pytest.mark.parametrize("esize", [2, 4])
def test_plan_covers_every_pair_once(pyramid, esize):
    """Every form reads each (query level, value level) pair exactly once:
    K7 takes the same-or-coarser levels and K6 the finer, K9 the wide query
    levels and K1 the runs of narrow ones, K8's groups partition the levels
    in order."""
    shapes = SHAPES[pyramid]
    every = {(lq, lv) for lq in range(5) for lv in range(5)}
    for form in forms.FORMS:
        pairs = [(lq, lv) for x in forms.plan_layer(form, shapes, 32, esize, 4)
                 for lq in x.query_levels for lv in x.value_levels]
        assert sorted(pairs) == sorted(every), form
    for x in forms.plan_layer("rows", shapes, 32, esize, 4):
        coarse = [not forms.finer(shapes[x.query_levels[0]], shapes[lv]) for lv in x.value_levels]
        assert all(coarse) if x.kernel == "msda_fwd_rows" else not any(coarse)
    for x in forms.plan_layer("dense", shapes, 32, esize, 4):
        wide = [shapes[lq][1] % 128 == 0 for lq in x.query_levels]
        assert all(wide) if x.kernel == "msda_fwd_dense" else not any(wide)
    for lq in range(5):
        groups = [x.value_levels for x in forms.plan_layer("qlevel", shapes, 32, esize, 4)
                  if x.query_levels == (lq,)]
        assert [lv for g in groups for lv in g] == list(range(5))
        modes = [x.out_mode for x in forms.plan_layer("qlevel", shapes, 32, esize, 4)
                 if x.query_levels == (lq,)]
        assert modes == (["value"] if len(groups) == 1
                         else ["store"] + ["continue"] * (len(groups) - 1))


@pytest.mark.parametrize("budget", [64 * 1024, 96 * 1024, 128 * 1024])
def test_qlevel_groups_fit_the_budget(budget):
    """A smaller shared-memory budget packs K8's levels into more groups,
    each within it: in f32 for the D = 32 body (its boxes take up to 162 KB
    at the 128^2 query level), in bf16 for the general one (a finer level's
    warp windows alone take 62 KB)."""
    for body, esize in (("d32", 4), ("general", 2)):
        full = forms.plan_layer("qlevel", PROTOCOL, 32, esize, 4, body=body)
        plan = forms.plan_layer("qlevel", PROTOCOL, 32, esize, 4, budget=budget, body=body)
        assert all(x.smem <= budget and x.body == body for x in plan)
        assert len(plan) > len(full), body


def _f32(x):
    return np.float32(x)


def _window_base(q, nq, nv, win):
    """csrc/msda_window.cuh's window_base in f32."""
    center = _f32(_f32(q + 0.5) / _f32(nq))
    c = _f32(_f32(center * _f32(nv)) - _f32(0.5))
    return int(np.floor(_f32(c + _f32(0.5)))) - (win - 3) // 2 - 1


# The plans whose boxes test_staged_windows_hold_every_corner holds to the
# windows: K8's general body, and the D = 32 bodies of K6, K7 (its ring
# slots) and K8, whose tiles are smaller
STAGING_PLANS = (("qlevel", "general"), ("pair", "d32"), ("rows", "d32"), ("qlevel", "d32"))


@pytest.mark.parametrize("pyramid", sorted(SHAPES))
def test_staged_windows_hold_every_corner(rng, pyramid):
    """The kernels' geometry, in f32 as they compute it: every bilinear
    corner of a clipped sample lies in its query's window (the per-query
    staging and K9's taps), and every window of a tile in the box the plan
    bounds (the tile staging: K8's general body, K6's, K7's and K8's D = 32
    bodies), so no corner is read from device memory; each of K7's boxes
    fits the ring slot it is staged in, in both element sizes."""
    shapes, radius = SHAPES[pyramid], 4
    win = forms.window_taps(radius)
    for esize in (2, 4):
        for x in forms.plan_layer("rows", shapes, 32, esize, radius, body="d32"):
            if x.kernel != "msda_fwd_rows":
                continue
            (lq,) = x.query_levels
            _, offsets, _, _, smem = forms._layout(x.kernel, shapes, lq, x.value_levels, x.tile,
                                                   32, esize, win, "d32")
            ends = [offsets[1] * esize if len(offsets) > 1 else smem, smem]
            for j, (h, w) in enumerate(x.boxes):
                assert offsets[j] * esize + h * w * 32 * esize <= ends[j % 2], (lq, j)
    for lq, (hq, wq) in enumerate(shapes):
        for lv, (hv, wv) in enumerate(shapes):
            for nq, nv in ((hq, hv), (wq, wv)):
                q = np.arange(nq)
                center = (q.astype(np.float32) + _f32(0.5)) / _f32(nq)
                off = np.clip(rng.uniform(-6, 6, (nq, 64)).astype(np.float32), -radius, radius)
                off[:, :2] = (-radius, radius)
                x = (center[:, None] + off / _f32(nv)) * _f32(nv) - _f32(0.5)
                x0 = np.floor(x).astype(int)
                base = np.array([_window_base(i, nq, nv, win) for i in q])
                assert (x0 >= base[:, None]).all() and (x0 + 1 <= base[:, None] + win - 1).all()
            x = [launch for form, body in STAGING_PLANS
                 for launch in forms.plan_layer(form, shapes, 32, 2, radius, body=body)
                 if launch.kernel != "msda_fwd"]
            for launch in x:
                if launch.query_levels != (lq,) or lv not in launch.value_levels:
                    continue
                box = launch.boxes[launch.value_levels.index(lv)]
                if box == (0, 0):
                    assert forms.finer(shapes[lq], shapes[lv])
                    continue
                for t, nq, nv, bound in ((launch.tile[0], hq, hv, box[0]),
                                         (launch.tile[1], wq, wv, box[1])):
                    for q0 in range(0, nq, t):
                        q1 = min(q0 + t, nq) - 1
                        extent = _window_base(q1, nq, nv, win) - _window_base(q0, nq, nv, win) + win
                        assert extent <= bound, (lq, lv, q0)


def _plain_launch(x, value, shapes, off, att, out, radius):
    """A form kernel's launch in plain torch (``window_qlevel_plain``): its
    query level's pairs over its value levels, from 0 or continued from the
    f32 partial in ``out`` as its out mode says, stored."""
    (lq,) = x.query_levels
    starts, _ = level_start_index(shapes)
    rows = slice(starts[lq], starts[lq] + shapes[lq][0] * shapes[lq][1])
    assert out.dtype == (value.dtype if x.out_mode == "value" else torch.float32)
    partial = out[:, rows].clone() if x.out_mode == "continue" else None
    part = forms.window_qlevel_plain(value, shapes, lq, off, att, radius, x.value_levels, partial)
    out[:, rows] = part.to(out.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["pair", "rows", "qlevel", "dense"])
def test_run_plan_assembles_the_window_op(rng, form, dtype):
    """The wrappers' plumbing with each kernel's launch done in plain torch:
    the f32 partials, their cast, K9's K1 runs and K8's groups (a budget of
    the warps' query windows and 4 KB more, per element byte, splits them)
    give the plain whole op."""
    from ape_tpu_torch.ops.msda import ms_deform_attn

    shapes, radius = ((8, 128), (4, 64), (2, 32)), 4
    value, off, att = (torch.from_numpy(x) for x in _inputs(rng, shapes, b=2, heads=2, d=8, p=2))
    value, att = value.to(dtype), att.to(dtype)
    plan = forms.plan_layer(form, shapes, 8, value.element_size(), radius,
                            budget=(forms.WARPS * 11 * 11 * 8 + 4096) * value.element_size())
    if form == "qlevel":
        assert len(plan) > len(shapes)  # grouped
    elif form == "dense":
        assert [x.kernel for x in plan] == ["msda_fwd_dense", "msda_fwd"]
    got = forms.run_plan(plan, value, shapes, off, att, radius, _plain_launch, ms_deform_attn)
    want = forms.window_plain(value, shapes, off, att, radius)
    assert got.dtype == dtype
    tol = TOL if dtype == torch.float32 else 2 ** -7 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("form", ["pair", "rows", "qlevel"])
@pytest.mark.parametrize("pyramid", ["three", "oblong"])
def test_run_plan_assembles_the_d32_window_op(rng, pyramid, form):
    """The D = 32 plans of K6, K7 (its finer pairs first, each query level's
    first launch storing the f32 partial and the rest continuing it) and K8
    at head width 32, each launch done in plain torch: the plain whole op,
    in f32."""
    shapes, radius = PYRAMIDS[pyramid]
    value, off, att = (torch.from_numpy(x) for x in _inputs(rng, shapes, b=2, heads=2, d=32, p=4))
    plan = forms.plan_layer(form, shapes, 32, 4, radius, body="d32")
    assert {x.body for x in plan} == {"d32"}
    got = forms.run_plan(plan, value, shapes, off, att, radius, _plain_launch, None)
    want = forms.window_plain(value, shapes, off, att, radius)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("pyramid", [p for p in sorted(PYRAMIDS) if len(PYRAMIDS[p][0]) > 1])
def test_qlevel_groups_continue_to_the_window_oracle(rng, pyramid):
    """The plain model of K8's groups at head width 32 (its D = 32 body's
    plan, the budget cut to force two or more groups a query level): each
    group's launch continues the f32 partial the one before stored
    (``window_qlevel_plain`` with ``partial``), and the chain over a query
    level's groups gives JAX's ms_deform_attn_window."""
    shapes, radius = PYRAMIDS[pyramid]
    value, off, att = (torch.from_numpy(x) for x in _inputs(rng, shapes, b=2, heads=2, d=32, p=2))
    want = np.asarray(jax_window(jnp.asarray(value.numpy()), shapes, jnp.asarray(off.numpy()),
                                 jnp.asarray(att.numpy()), radius=radius))
    budget = 24 * 1024
    plan = forms.plan_layer("qlevel", shapes, 32, 4, radius, budget=budget)
    starts, _ = level_start_index(shapes)
    most = 0
    for lq, (hq, wq) in enumerate(shapes):
        groups = [x for x in plan if x.query_levels == (lq,)]
        most = max(most, len(groups))
        assert [x.out_mode for x in groups] == (
            ["value"] if len(groups) == 1 else ["store"] + ["continue"] * (len(groups) - 1))
        rows = None
        for x in groups:
            assert x.body == "d32" and x.smem <= budget
            rows = forms.window_qlevel_plain(value, shapes, lq, off, att, radius, x.value_levels,
                                             rows)
        np.testing.assert_allclose(rows.numpy(), want[:, starts[lq]:starts[lq] + hq * wq],
                                   rtol=0, atol=TOL, err_msg=f"query level {lq}")
    assert most >= 2


def test_form_cuda_refuses_cpu_tensors(rng):
    """The CUDA wrapper launches or raises: no quiet fallback for CPU tensors."""
    shapes = ((16, 16), (8, 8))
    value, off, att = (torch.from_numpy(x) for x in _inputs(rng, shapes, heads=8, d=8, p=2))
    for form in ("pair", "rows", "qlevel", "dense"):
        with pytest.raises(ValueError, match="CUDA"):
            forms.window_form_cuda(form, value, shapes, off, att, 2)


HEADS8 = dict(DIMS, heads=8)


def _tiny_batch():
    img, sizes, text, valid = tiny_inputs(HEADS8, h=200, w=240)
    targets = {"labels": torch.tensor([[0, 3, 0]]),
               "boxes": torch.tensor([[[0.35, 0.4, 0.3, 0.35], [0.6, 0.55, 0.25, 0.4],
                                       [0.5, 0.5, 0.1, 0.1]]]),
               "valid": torch.tensor([[True, True, False]])}
    return {"images": torch.from_numpy(img), "image_sizes": torch.from_numpy(sizes),
            "text_features": torch.from_numpy(text), "text_valid": torch.from_numpy(valid),
            "targets": targets}


@pytest.fixture(scope="module")
def tiny_default():
    """A tiny APE-Ti (8 heads, the protocol pyramid) and its forward outputs,
    loss and gradients with both flags off."""
    torch.manual_seed(0)
    model = torch_tiny_protocol(HEADS8)
    batch = _tiny_batch()
    with torch.no_grad():
        out = model.eval()(batch["images"], batch["image_sizes"], batch["text_features"],
                           batch["text_valid"])
    return model, batch, out, _step(model, batch)


def _step(model, batch):
    model.train().zero_grad()
    crit = DeformableCriterion(num_classes=HEADS8["num_text"] + 1, num_queries=HEADS8["queries"],
                               weight_dict=default_weight_dict())
    total, _, _ = loss_fn(model, crit, batch, torch.Generator().manual_seed(0))
    total.backward()
    return total.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                            if p.grad is not None}


@pytest.mark.parametrize("flag", ["FUSED", "V6"])
def test_tiny_model_forward_and_step_under_each_flag(monkeypatch, tiny_default, flag):
    """On the CPU a tiny APE-Ti under either flag gives the default form's
    forward outputs, loss and every gradient."""
    model, batch, want_out, (want_total, want_grads) = tiny_default
    monkeypatch.setattr(msda_dispatch, flag, True)
    with torch.no_grad():
        out = model.eval()(batch["images"], batch["image_sizes"], batch["text_features"],
                           batch["text_valid"])
    for k in ("pred_logits", "pred_boxes"):
        assert torch.equal(out[k], want_out[k]), k
    total, grads = _step(model, batch)
    assert torch.equal(total, want_total)
    assert grads.keys() == want_grads.keys()
    assert all(torch.equal(grads[n], g) for n, g in want_grads.items())


# ---- the TPU kernels themselves, in interpret mode (slow) ----


@pytest.mark.slow
@pytest.mark.parametrize("version", ["v1", "v3", "v5"])
def test_plain_matches_tpu_kernels_in_interpret_mode(rng, version):
    """The port's plain version against the Pallas kernels K6 (v1), K7 (v3)
    and K8 (v5) run in interpret mode, at the JAX tests' geometry and
    tolerance (2e-2: the TPU kernels keep bf16 planes)."""
    import importlib

    module = importlib.import_module(f"experiments.msda_window_pallas_{version}")
    fn = {"v1": "ms_deform_attn_window_pallas"}.get(version, f"ms_deform_attn_window_pallas_{version}")
    shapes = ((8, 8), (4, 4))
    value, off, att = _inputs(rng, shapes, heads=2, d=8, p=2, max_off=3.0)
    want = getattr(module, fn)(jnp.asarray(value), shapes, jnp.asarray(off), jnp.asarray(att),
                               radius=2, interpret=True)
    got = forms.window_plain(torch.from_numpy(value), shapes, torch.from_numpy(off),
                             torch.from_numpy(att), 2)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 2e-2


@pytest.mark.slow
def test_plain_matches_dense_tpu_kernel_in_interpret_mode(rng):
    """The port's plain version against K9 (v6) in interpret mode on its
    mixed geometry (a 128-wide query level on v6, a narrower one on v2)."""
    from experiments.msda_window_pallas_v6 import ms_deform_attn_window_pallas_v6

    shapes = ((8, 128), (4, 64))
    value, off, att = _inputs(rng, shapes, heads=8, d=32, p=4, max_off=6.0)
    want = ms_deform_attn_window_pallas_v6(jnp.asarray(value), shapes, jnp.asarray(off),
                                           jnp.asarray(att), radius=4, interpret=True)
    got = forms.window_plain(torch.from_numpy(value), shapes, torch.from_numpy(off),
                             torch.from_numpy(att), 4)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 2e-2
