"""The probes of the port (K10: ops/msda_pair_probe.py and
tools/pair_probe.py; K11: the tiles of ops/attention.py and
tools/backbone_fix_probe.py) against the JAX repository's probes on the CPU.

The CUDA kernels run only on a card (tests/test_torch_kernels.py); here the
plain version of each K10 variant that computes the whole function is held
to experiments/pair_probe.py's run_pair_variant, and K11's plain attention
to the library flash_attention, both in interpret mode (their pallas_call
patched by monkeypatch, nothing in experiments/ changed). The ablations'
plain versions are held to the identities that define them. The
interpret-mode comparisons beyond one per geometry are marked slow.
"""

import functools
import inspect
import math
import re
from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import experiments.pair_probe as jax_probe
from ape_tpu_torch.modeling.backbone.eva_vit import PatchEmbed
from ape_tpu_torch.ops import _build
from ape_tpu_torch.ops import attention
from ape_tpu_torch.ops import msda_pair_probe as k10
from ape_tpu_torch.ops.msda_window_forms import window_pair_plain
from ape_tpu_torch.tools import backbone_fix_probe, msda_bwd_race, msda_race, pair_probe

# (hq, wq, hv, wv): value as fine as the queries, coarser by 2, finer by 2
GEOMETRIES = {"same": (16, 16, 16, 16), "coarser": (16, 16, 8, 8), "finer": (8, 8, 16, 16)}
TOL = 1e-5       # f32, sums in another order
BF16_TOL = 3.2e-2  # a side that rounds weights or sums to bf16


def _interpret(monkeypatch, module):
    """Run ``module``'s Pallas calls in interpret mode on the CPU."""
    monkeypatch.setattr(module.pl, "pallas_call",
                        functools.partial(module.pl.pallas_call, interpret=True))


def _tpu_probe(monkeypatch, variant, geometry):
    """experiments/pair_probe.py's variant and the port's inputs on the same
    draws: (JAX output in the port's (B, Q, H * D) layout, value, locations,
    attention weights). The value is bf16-rounded (the TPU probe stages it in
    bf16) and the TPU probe's channel c = d * H + h."""
    _interpret(monkeypatch, jax_probe)
    hq, wq, hv, wv = GEOMETRIES[geometry]
    value, off, loc, att = pair_probe.pair_inputs(hq, wq, hv, wv, "cpu", torch.bfloat16)
    h, d = k10.HEADS, k10.HEAD_DIM
    v_l = value.float().transpose(2, 3).reshape(1, hv * wv, d * h).numpy()
    out = np.asarray(jax_probe.run_pair_variant(variant, jnp.asarray(v_l), jnp.asarray(off.numpy()),
                                                jnp.asarray(att.numpy()), hq, wq, hv, wv))
    out = out.reshape(1, hq * wq, d, h).transpose(0, 1, 3, 2).reshape(1, hq * wq, h * d)
    return out, value, loc, att


def test_port_probe_has_the_tpu_probes_geometry():
    assert k10.PAIRS == jax_probe.PAIRS
    assert (k10.HEADS, k10.HEAD_DIM, k10.POINTS, k10.RADIUS) == (jax_probe.H, jax_probe.D,
                                                                 jax_probe.P, jax_probe.RADIUS)


def test_every_tpu_variant_maps_to_a_port_variant():
    """The variant names make_kernel tests for (and its default, base) are
    exactly JAX_VARIANTS' keys, and each maps to a port variant."""
    src = inspect.getsource(jax_probe.make_kernel)
    names = {"base"}
    for m in re.finditer(r'variant(?:\.startswith\(| == | in \()([^)\n:]*)', src):
        names |= set(re.findall(r'"(\w+)"', m.group(1)))
    assert names == set(k10.JAX_VARIANTS)
    assert set(k10.JAX_VARIANTS.values()) == set(k10.VARIANTS)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_base_matches_tpu_probe_in_interpret_mode(monkeypatch, geometry):
    want, value, loc, att = _tpu_probe(monkeypatch, "base", geometry)
    hv, wv = GEOMETRIES[geometry][2:]
    got = k10.pair_probe_plain("base", value, loc, att, hv, wv)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# The TPU probe's variants that compute the whole function, the port variant
# they map to, and the bound: k32_t and the u-loops round their tap weights
# to bf16 (pair_probe.py:138-143, 251), as k32_bf16 and bf16fma do.
FULL = {"k32": TOL, "tile": TOL, "k32_t": BF16_TOL, "u8": BF16_TOL, "u4": BF16_TOL,
        "uskip": BF16_TOL, "k32_bf16": BF16_TOL, "bf16fma": BF16_TOL}


@pytest.mark.slow
@pytest.mark.parametrize("variant,geometry", [
    (v, g) for v in sorted(FULL) for g in sorted(GEOMETRIES)
    # JAX's bf16fma (and viewonly) reads pl.ds(dy, tq) value rows with no
    # inv_y broadcast (pair_probe.py:232, 238; base reads them at :290-294),
    # so where the value level is coarser it samples the wrong rows (6.1 off)
    if not (v == "bf16fma" and g == "coarser")])
def test_full_function_variants_match_tpu_probe_in_interpret_mode(monkeypatch, variant, geometry):
    want, value, loc, att = _tpu_probe(monkeypatch, variant, geometry)
    hv, wv = GEOMETRIES[geometry][2:]
    got = k10.pair_probe_plain(k10.JAX_VARIANTS[variant], value, loc, att, hv, wv)
    assert float(np.abs(got.numpy() - want).max()) <= FULL[variant]


def _small_pair(rng, hq=4, wq=5, hv=3, wv=6, b=2, h=2, p=3, d=4, max_off=6.0):
    value = torch.from_numpy(rng.randn(b, hv * wv, h, d).astype(np.float32))
    off = torch.from_numpy(rng.uniform(-max_off, max_off, (b, hq * wq, h, p, 2)).astype(np.float32))
    att = torch.from_numpy(rng.rand(b, hq * wq, h, p).astype(np.float32))
    return value, off, k10.pair_locations(off, hq, wq, hv, wv, 4.0), att


def test_no_corners_is_the_window_pair_on_ones(rng):
    value, off, loc, att = _small_pair(rng)
    want = window_pair_plain(torch.ones_like(value), off, att, 4, 5, 3, 6, 4.0)
    got = k10.pair_probe_plain("no_corners", value, loc, att, 3, 6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_corners_only_and_const_w_against_a_loop(rng):
    """corners_only against an independent loop over samples and corners:
    a live sample (-1 <= x < W, -1 <= y < H, x = loc * W - 0.5) adds every
    corner inside the level; const_w is 0.01 times it."""
    hv, wv = 3, 6
    value, _, loc, att = _small_pair(rng, hv=hv, wv=wv)
    v, lc = value.numpy(), loc.numpy()
    b, q, h, p, _ = lc.shape
    want = np.zeros((b, q, h, v.shape[-1]), np.float32)
    for i in np.ndindex(b, q, h, p):
        x = np.float32(lc[i][0] * np.float32(wv)) - np.float32(0.5)
        y = np.float32(lc[i][1] * np.float32(hv)) - np.float32(0.5)
        if not (-1 <= x < wv and -1 <= y < hv):
            continue
        for cy in (int(np.floor(y)), int(np.floor(y)) + 1):
            for cx in (int(np.floor(x)), int(np.floor(x)) + 1):
                if 0 <= cx < wv and 0 <= cy < hv:
                    want[i[:3]] += v[i[0], cy * wv + cx, i[2]]
    got = k10.pair_probe_plain("corners_only", value, loc, att, hv, wv)
    np.testing.assert_allclose(got.numpy(), want.reshape(b, q, -1), rtol=0, atol=1e-5)
    const = k10.pair_probe_plain("const_w", value, loc, att, hv, wv)
    np.testing.assert_allclose(const.numpy(), k10.CONST_W * got.numpy(), rtol=1e-6, atol=1e-7)


def test_store_only_and_the_same_function_variants(rng):
    value, off, loc, att = _small_pair(rng)
    store = k10.pair_probe_plain("store_only", value, loc, att, 3, 6)
    want = att.sum(-1, keepdim=True).expand(-1, -1, -1, value.shape[-1]).reshape(store.shape)
    assert torch.equal(store, want)
    base = k10.pair_probe_plain("base", value, loc, att, 3, 6)
    for variant in ("vec2", "branchless"):
        assert torch.equal(k10.pair_probe_plain(variant, value, loc, att, 3, 6), base)
    np.testing.assert_allclose(base.numpy(), window_pair_plain(value, off, att, 4, 5, 3, 6,
                                                               4.0).numpy(), rtol=0, atol=TOL)
    blend = k10.pair_probe_plain("bf16fma", value, loc, att, 3, 6)
    err = float((blend - base).abs().max())
    assert 0 < err <= BF16_TOL  # rounded in bf16, by a few bf16 steps at most


# One sample inside a 2 x 2 level: its four corners and its location. In
# "tie", corner 01's product with its weight 0.75 lies halfway between two
# bf16 values and corner 00 adds 1e-30 first: rounded once, the sum goes up;
# rounded to f32 first, it lands on the tie and goes down to even.
BLEND_CASES = {"mixed": ([1.7, 3.3, -2.1, 1.05], [0.4, 0.7]),
               "tie": ([1e-30, 1 + 3 / 128, 0.0, 0.0], [0.625, 0.25])}


def _round_once(x: Fraction) -> Fraction:
    """x rounded to bf16, to nearest, ties to even, in exact arithmetic."""
    if x == 0:
        return x
    _, e = math.frexp(float(x))  # 2^(e-1) <= |x| < 2^e
    return round(x * Fraction(2) ** (8 - e)) * Fraction(2) ** (e - 8)


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_bf16_blend_rounds_after_every_corner(case):
    """The blend rounds each corner and its weight to bf16, and the exact
    product plus the sum so far once to bf16 after each corner, as an FMA
    does, in the kernel's order (00, 01, 10, 11), then scales by the
    attention weight in f32."""
    f32 = np.float32
    corners, (lx, ly) = BLEND_CASES[case]
    value = torch.tensor(corners).view(1, 4, 1, 1).expand(1, 4, 1, 32).contiguous()
    loc = torch.tensor([lx, ly]).view(1, 1, 1, 1, 2)
    att = torch.full((1, 1, 1, 1), 0.9)
    got = k10.pair_probe_plain("bf16fma", value, loc, att, 2, 2)

    def bf(x):
        return float(torch.tensor(float(x), dtype=torch.float32).to(torch.bfloat16))

    x, y = f32(f32(lx) * f32(2)) - f32(0.5), f32(f32(ly) * f32(2)) - f32(0.5)
    fx, fy = x - np.floor(x), y - np.floor(y)
    weights = ((f32(1) - fx) * (f32(1) - fy), fx * (f32(1) - fy), (f32(1) - fx) * fy, fx * fy)
    v, twice = Fraction(0), 0.0
    for c, w in zip(corners, weights):
        v = _round_once(v + Fraction(bf(w)) * Fraction(bf(c)))
        twice = bf(f32(twice) + f32(bf(w) * bf(c)))
    assert torch.equal(got, torch.full((1, 1, 32), float(f32(0.9) * f32(v))))
    assert not torch.equal(got, k10.pair_probe_plain("base", value, loc, att, 2, 2))
    assert (v == twice) == (case == "mixed")


def test_pair_probe_wrappers_on_the_cpu(rng):
    value, _, loc, att = _small_pair(rng, d=32)
    for variant in k10.VARIANTS:
        assert torch.equal(k10.pair_probe(variant, value, loc, att, 3, 6),
                           k10.pair_probe_plain(variant, value, loc, att, 3, 6))
    with pytest.raises(ValueError, match="variant"):
        k10.pair_probe("k32", value, loc, att, 3, 6)
    with pytest.raises(ValueError, match="CUDA"):
        k10.pair_probe_cuda("base", value, loc, att, 3, 6)


# ---- K11 ----


@pytest.mark.parametrize("block", [128, 256])
def test_plain_attention_matches_library_flash_in_interpret_mode(monkeypatch, rng, block):
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    _interpret(monkeypatch, fa)
    q, k, v = (rng.randn(1, 2, 256, 64).astype(np.float32) for _ in range(3))
    sizes = fa.BlockSizes(block_q=block, block_k_major=block, block_k=block, block_b=1)
    want = fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=0.125,
                              block_sizes=sizes)
    got = attention.global_attention_plain(*map(torch.from_numpy, (q, k, v)), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


# shared bytes a block at head width 64. f32 body: 31, 67, 116, 99, 164 KB;
# bf16 body (Q, two buffers each of K and V, rows of 64 + 8 bf16): 23, 45,
# 81, 54, 90 KB
TILE_SMEM_64 = {(32, 32): 31232, (64, 64): 68608, (64, 128): 118784, (128, 64): 101376,
                (128, 128): 167936}
TILE_SMEM_64_BF16 = {(32, 32): 23040, (64, 64): 46080, (64, 128): 82944, (128, 64): 55296,
                     (128, 128): 92160}


def test_attn_tile_shared_memory():
    f32, bf16 = torch.float32, torch.bfloat16
    assert {t: attention.attn_tile_smem(*t, 64, f32) for t in attention.TILES} == TILE_SMEM_64
    assert {t: attention.attn_tile_smem(*t, 64, bf16) for t in attention.TILES} == TILE_SMEM_64_BF16
    assert all(attention.attn_tile_fits(*t, 64, d) for t in attention.TILES for d in (f32, bf16))
    assert attention.attn_tile_smem(128, 128, 128, f32) == 268288  # 262 KB
    assert not attention.attn_tile_fits(128, 128, 128, f32)
    assert attention.attn_tile_fits(128, 64, 128, f32)
    # every tile fits in bf16 at head width 128: (128, 128) takes 170 KB
    assert attention.attn_tile_smem(128, 128, 128, bf16) == 174080
    assert all(attention.attn_tile_fits(*t, 128, bf16) for t in attention.TILES)
    # the TPU probe's 1024-row blocks: about 4.8 MB of f32 staging, 720 KB in bf16
    assert attention.attn_tile_smem(1024, 1024, 64, f32) == 4999168
    assert attention.attn_tile_smem(1024, 1024, 64, bf16) == 737280
    assert not any(attention.attn_tile_fits(1024, 1024, 64, d) for d in (f32, bf16))


def test_attn_fwd_tiles_refuses_before_launch(rng):
    q = torch.from_numpy(rng.randn(1, 2, 40, 128).astype(np.float32))
    want = attention.global_attention_plain(q, q, q, 0.1)
    assert torch.equal(attention.attn_fwd_tiles(q, q, q, 0.1, 128, 64), want)
    with pytest.raises(ValueError, match="shared memory"):
        attention.attn_fwd_tiles(q, q, q, 0.1, 128, 128)
    with pytest.raises(ValueError, match="tiles"):
        attention.attn_fwd_tiles(q, q, q, 0.1, 48, 48)
    with pytest.raises(ValueError, match="CUDA"):
        attention.attn_fwd_tiles_cuda(q, q, q, 0.1, 64, 64)
    assert _build.LAUNCHES["attn_fwd_tiles"] == 0


def test_patchify_conv_matches_the_matmul(rng):
    embed = PatchEmbed(3, 192, 16)
    img = torch.from_numpy(rng.randn(1, 64, 96, 3).astype(np.float32))
    with torch.no_grad():
        want = F.conv2d(img.permute(0, 3, 1, 2), embed.proj.weight, embed.proj.bias,
                        stride=16).permute(0, 2, 3, 1)
        got = embed(img)
    assert got.shape == (1, 4, 6, 192)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# ---- the tools, plain versions only ----


def test_pair_probe_tool_on_the_cpu(capsys):
    recs = pair_probe.probe(device="cpu", pairs={"tiny": (16, 16, 8, 8)})
    assert [r["variant"] for r in recs] == list(k10.VARIANTS)
    for rec in recs:
        assert {"pair", "geometry", "variant", "jax", "ms", "plain_ms", "bound_ms", "bound_by",
                "share_of_base", "max_abs_err", "bound", "card"} <= rec.keys()
        assert rec["ms"] is None and rec["max_abs_err"] == 0.0
    assert recs[0]["equals_msda_fwd"] is True
    assert 0 < recs[k10.VARIANTS.index("bf16fma")]["max_abs_err_vs_base"] <= BF16_TOL
    assert pair_probe.failures(recs) == []
    assert len(capsys.readouterr().out.splitlines()) == len(recs)
    assert pair_probe._variants("base,no_fma,k32,tile") == ("base", "no_corners", "vec2")


def test_backbone_fix_probe_tool_on_the_cpu():
    recs = backbone_fix_probe.probe(device="cpu", shape=(1, 2, 128, 64), image=64)
    attn = {r["name"]: r for r in recs if r["phase"] == "probe_attn"}
    assert set(attn) == {"einsum_f32", "einsum_bf16", "attn_fwd", "sdpa", "tile_1024x1024",
                         *(f"tile_{bq}x{bk}" for bq, bk in attention.TILES)}
    assert attn["tile_1024x1024"]["fits"] is False and attn["tile_1024x1024"]["ms"] is None
    assert attn["tile_64x64"]["equals_attn_fwd"] is True
    assert all(attn[f"tile_{bq}x{bk}"]["max_abs_err"] == 0.0 for bq, bk in attention.TILES)
    patch = [r for r in recs if r["phase"] == "probe_patchify"]
    assert [r["name"] for r in patch] == ["conv", "matmul"]
    assert patch[0]["out"] == [1, 4, 4, 192] and patch[0]["parity_max_abs_diff"] < 3.2e-2
    assert backbone_fix_probe.failures(recs) == []


def test_msda_bwd_race_tool_on_the_cpu(capsys):
    """The backward race's plumbing at a tiny pyramid: one record per draw
    and form, the plain version in every form's place (errors 0, no times),
    each form's bound, and the failures its bounds would report."""
    recs = msda_bwd_race.race(device="cpu", pyramids={"tiny": (((8, 8), (4, 4)), 2)}, iters=2)
    assert [(r["draw"], r["form"]) for r in recs] == [
        (d, f) for d in msda_race.DRAWS for f in msda_bwd_race.FORMS]
    for rec in recs:
        assert {"pyramid", "batch", "tokens", "draw", "dtype", "form", "kernels", "launches",
                "median_ms", "min_ms", "max_ms", "iters", "card"} <= rec.keys()
        assert rec["tokens"] == 80 and rec["median_ms"] is None and rec["launches"] == {}
    by_form = {f: [r for r in recs if r["form"] == f] for f in msda_bwd_race.FORMS}
    for rec in by_form["merged"]:
        assert rec["rel_err_vs_plain"] == dict.fromkeys(msda_bwd_race.OUTPUTS, 0.0)
    for rec in by_form["split"]:
        assert rec["rel_err_vs_merged"] == dict.fromkeys(msda_bwd_race.OUTPUTS, 0.0)
        assert rec["bound_ms"] > by_form["merged"][0]["bound_ms"] > 0
    assert "bound_ms" not in by_form["plain"][0]
    assert msda_bwd_race.failures(recs) == []
    wrong = dict(by_form["merged"][0], rel_err_vs_plain={"d_loc": 2e-2})
    assert len(msda_bwd_race.failures([wrong])) == 1
    assert len(capsys.readouterr().out.splitlines()) == len(recs)


@pytest.mark.parametrize("tool", [pair_probe, backbone_fix_probe])
def test_tools_need_a_card_unless_told_cpu(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA"):
        tool.probe()


def test_msda_bwd_race_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA"):
        msda_bwd_race.race()


def test_ptxas_info_reads_the_build_log(tmp_path):
    log = tmp_path / "nvcc.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kv\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 380 bytes cmem[0]\n")
    assert _build.ptxas_info(log) == {"_Z1kv": {"spill_stores": 12, "spill_loads": 16,
                                                "registers": 255}}


# A cuobjdump -sass excerpt: a bf16 instance on the tensor cores (cp.async,
# ldmatrix, mma.sync), an f32 one on FMAs, and a kernel the pattern skips.
SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_115attn_fwd_kernelILi64ELi64ELi64E13__nv_bfloat16EEvPKT2_S4_S4_PS2_Pfif
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0090*/              @!P0 LDGSTS.E.BYPASS.LTC128B.128 [R5], desc[UR6][R2.64] ;
        /*00a0*/                   LDGDEPBAR ;
        /*00b0*/                   DEPBAR.LE SB0, 0x1 ;
        /*00c0*/                   LDSM.16.M88.4 R8, [R12] ;
        /*00d0*/                   LDSM.16.MT88.4 R16, [R12+0x800] ;
        /*00e0*/                   HMMA.16816.F32.BF16 R20, R8, R16, R20 ;
        /*00f0*/                   HMMA.16816.F32.BF16 R24, R8, R18, R24 ;
        /*0100*/                   STG.E [R2.64], R20 ;
		Function : _ZN12_GLOBAL__N_115attn_fwd_kernelILi64ELi64ELi64EfEEvPKT2_S3_S3_PS1_Pfif
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0010*/                   FFMA R5, R4, R4, R5 ;
        /*0020*/                   STG.E [R2.64], R5 ;
		Function : _ZN12_GLOBAL__N_115msda_fwd_kernelIffEEvv
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
"""


def _ops(**nonzero):
    return dict(dict.fromkeys(_build.SASS_OPS + ("REDG_V4",), 0), **nonzero)


def test_parse_sass_counts_tensor_core_ops():
    counts = _build.parse_sass(SASS, "attn_fwd_kernel")
    bf16, f32 = sorted(counts, key=lambda n: "__nv_bfloat16" not in n)
    assert counts[bf16] == _ops(STG=1, HMMA=2, LDSM=2, LDGSTS=1)
    assert counts[f32] == _ops(LDG=1, STG=1)
    assert list(_build.parse_sass(SASS, "msda_fwd_kernel").values()) == [_ops(LDG=1)]


# A cuobjdump -sass excerpt of the merged MSDA backward (H100, sm_90a): the
# D = 32 body's vector reductions (atomicAdd on float4) and the other body's
# scalar ones.
SASS_RED = """
		Function : _ZN44_GLOBAL__N__5246dc38_11_msda_bwd_cu_ffe0d3cf19msda_bwd_kernel_d32IffEEvPKT_PKfPKT0_PKlSA_S3_PfSB_SB_iiiiii
        /*0990*/                   LDG.E.128.CONSTANT R8, desc[UR6][R12.64] ;
        /*0a10*/                   LDG.E.64.CONSTANT R4, desc[UR6][R2.64] ;
        /*1470*/              @P0 REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU desc[UR10][R14.64], R32 ;
        /*1510*/                   REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU desc[UR10][R16.64], R36 ;
        /*1600*/                   STG.E.64 desc[UR6][R6.64], R20 ;
		Function : _ZN44_GLOBAL__N__5246dc38_11_msda_bwd_cu_ffe0d3cf15msda_bwd_kernelIffEEvPKT_PKfPKT0_PKlSA_S3_PfSB_SB_iiiiiii
        /*1470*/                   REDG.E.ADD.F32.FTZ.RN.STRONG.GPU desc[UR10][R14.64], R33 ;
        /*15b0*/              @P1 REDG.E.ADD.F32.FTZ.RN.STRONG.GPU desc[UR10][R4.64], R15 ;
"""


def test_parse_sass_counts_vector_reductions():
    (d32,) = _build.parse_sass(SASS_RED, "msda_bwd_kernel_d32").values()
    assert d32 == _ops(LDG=2, STG=1, REDG=2, REDG_V4=2)
    counts = _build.parse_sass(SASS_RED, "msda_bwd_kernel")
    assert sorted(c["REDG_V4"] for c in counts.values()) == [0, 2]
    assert sorted(c["REDG"] for c in counts.values()) == [2, 2]
