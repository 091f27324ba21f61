"""Split the window-MSDA pair kernel's time by stage on one CUDA card, from
the root of a checkout:

    python3 -m ape_tpu_torch.tools.pair_probe [pair] [variants] [--iters N]

The counterpart of the JAX repository's ``experiments/pair_probe.py``. It
runs K10 (``csrc/msda_pair_probe.cu``: K1's gather on one (query level,
value level) pair, on K1's D = 32 layout, ``ops/msda_pair_probe.py``) in its
variants on the TPU probe's pairs (``PAIRS``: same 256^2 <- 256^2, inv2
256^2 <- 128^2, inv4 256^2 <- 64^2, sx2 128^2 <- 256^2) at H 8, P 4, D 32,
radius 4, batch 1, with the TPU probe's draws (seed 0: value N(0, 1),
offsets 2 N(0, 1) pixels, attention weights U(0, 1) in f32), with the value
in bf16 and in f32 (``DTYPES``). ``pair`` is one of ``PAIRS`` or ``all``
(default ``same``); ``variants`` a comma list of the port's ``VARIANTS``
or of the TPU probe's names (``JAX_VARIANTS`` maps them), or ``all``
(default: the TPU probe's default, base, const_w, no_fma, k32, tile).

Each variant is held against its plain version in every run (``BOUND``),
``base`` against K1 on the pair (bit for bit after rounding to the value's
dtype: in f32 exactly), and ``bf16fma`` against the exact function
(``BF16FMA_VS_BASE``). Each record is one JSON line: the pair, the value's
dtype, the variant, its time (CUDA events over ``iters`` calls after a
warm-up), its plain version's, the pair's bound (value, locations, weights
and the f32 output once at 3.35 TB/s, or its f32 sample arithmetic at 67
TFLOP/s), its share of ``base``, its error, and the card's name and power
limit; ``base``'s also K1's time on the pair (``msda_fwd_ms``). Per pair and
dtype a ``probe_split`` line (``stage_split``) gives base - no_corners (the
corner loads), base - const_w (the weight math and the attention-weight
load), store_only (launch and store), K1's time and base's over it. Then,
from the build, each instance's static global loads and stores in SASS and
its registers and spills. ``chip_smoke.py`` calls ``probe``; ``device="cpu"``
runs only the plain versions, untimed.
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch

from ape_tpu_torch.ops import _build
from ape_tpu_torch.ops.msda import ms_deform_attn
from ape_tpu_torch.ops.msda_pair_probe import (
    HEAD_DIM,
    HEADS,
    JAX_VARIANTS,
    PAIRS,
    POINTS,
    RADIUS,
    VARIANTS,
    pair_locations,
    pair_probe,
    pair_probe_plain,
)
from ape_tpu_torch.tools.msda_race import HBM_BYTES_PER_S, card_line, cuda_ms

SEED = 0
DTYPES = (torch.bfloat16, torch.float32)  # the value's
DEFAULT_VARIANTS = ("base", "const_w", "no_fma", "k32", "tile")  # experiments/pair_probe.py's
# |kernel - plain| of every variant, whatever the value's dtype: both are f32
# outputs of the same inputs, their f32 sums in another order (bf16fma's
# plain version rounds its bf16 blend exactly as the kernel's FMAs do).
BOUND = 1e-5
# |bf16fma - base|: each blend rounds to bf16 four times, a step 2^-5 at
# magnitudes 4-8; two such steps.
BF16FMA_VS_BASE = 6.4e-2
PEAK_F32_FLOPS = 67e12     # f32 outside the tensor cores
SAMPLE_FLOPS = 10          # f32 flops a (sample, channel): 4 corner FMAs and the weight's


def device_or_card(device) -> torch.device:
    """The device to probe: the card unless ``device`` says otherwise; a
    card that is not there raises."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probe times the CUDA kernels: it needs an NVIDIA card "
                           "(device='cpu' runs the plain versions alone)")
    return dev


def pair_inputs(hq: int, wq: int, hv: int, wv: int, dev, dtype=torch.bfloat16):
    """The TPU probe's draws (``pair_probe.py:371-375``) for a pair, batch
    1: value (1, hv * wv, H, D) in dtype, read head-minor as the TPU probe
    lays it out (channel d * H + h), pixel offsets (1, hq * wq, H, P, 2),
    their clipped locations and attention weights (1, hq * wq, H, P), all
    f32 but the value, on dev."""
    rng = np.random.RandomState(SEED)
    v = rng.randn(1, hv * wv, HEAD_DIM * HEADS).astype(np.float32)
    off = (rng.randn(1, hq * wq, HEADS, POINTS, 2) * 2).astype(np.float32)
    att = rng.rand(1, hq * wq, HEADS, POINTS).astype(np.float32)
    value = torch.from_numpy(v).view(1, hv * wv, HEAD_DIM, HEADS).transpose(2, 3)
    off = torch.from_numpy(off).to(dev)
    loc = pair_locations(off, hq, wq, hv, wv, RADIUS).contiguous()
    return value.to(dev, dtype).contiguous(), off, loc, torch.from_numpy(att).to(dev)


def pair_bound(queries: int, values: int, esize: int):
    """(bound_ms, bound_by) of one pair at batch 1: value, locations (f32),
    weights (f32) and the f32 output once at 3.35 TB/s, against
    SAMPLE_FLOPS a sample and channel at 67 TFLOP/s."""
    nbytes = HEADS * (values * HEAD_DIM * esize + queries * POINTS * 12 + queries * HEAD_DIM * 4)
    flops = queries * HEADS * POINTS * HEAD_DIM * SAMPLE_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# K10's two bodies (csrc/msda_pair_probe.cu): the 8-lane one, templated on
# (variant, value), and vec2's, on the value alone
_SASS_NAME = re.compile(r"msda_pair_probe_kernel_(?:d32ILi(\d+)E|vec2I)(f|13__nv_bfloat16)E")


def sass_instance(name: str):
    """(variant, value dtype) of an instance of either K10 body, from its
    mangled name; None for another function."""
    m = _SASS_NAME.search(name)
    if m is None:
        return None
    variant = VARIANTS[int(m.group(1))] if m.group(1) else "vec2"
    return variant, "float32" if m.group(2) == "f" else "bfloat16"


def sass_records(card: str):
    """Each K10 instance's static global loads and stores (SASS) and its
    registers and spills (``-Xptxas -v``), one record each, both bodies;
    raises if the library holds none."""
    info = _build.ptxas_info()
    recs = []
    for name, ops in sorted(_build.sass_counts("msda_pair_probe_kernel_").items()):
        found = sass_instance(name)
        if found is None:
            continue
        variant, dtype = found
        body = "vec2" if variant == "vec2" else "d32"
        recs.append(dict(phase="probe_sass", kernel=f"msda_pair_probe_kernel_{body}",
                         variant=variant, dtype=dtype, **ops, **info.get(name, {}), card=card))
    if not recs:
        raise RuntimeError("the built library holds no instance of msda_pair_probe_kernel_d32 "
                           "or msda_pair_probe_kernel_vec2")
    return recs


def stage_split(pair: str, dtype: str, ms: dict, msda_fwd_ms: float, bound_ms: float,
                card: str) -> dict:
    """The ``probe_split`` record of one pair and dtype, from the variants'
    times ``ms``: the corner loads (base - no_corners), the weight math and
    the attention-weight load (base - const_w), launch and store
    (store_only), and base beside K1 on the pair."""
    return dict(phase="probe_split", pair=pair, dtype=dtype, base_ms=ms["base"],
                corner_loads_ms=ms["base"] - ms["no_corners"],
                weight_math_ms=ms["base"] - ms["const_w"], launch_store_ms=ms["store_only"],
                msda_fwd_ms=msda_fwd_ms, base_vs_msda_fwd=ms["base"] / msda_fwd_ms,
                bound_ms=bound_ms, card=card)


def probe(device=None, card: str = "", pairs=None, variants=VARIANTS, iters: int = 20):
    """Run the variants on the pairs (``PAIRS`` by default; a dict of name ->
    (hq, wq, hv, wv)) with the value in each of ``DTYPES``, each against its
    plain version, timed on a card. Prints each record as a JSON line and
    returns them."""
    dev = device_or_card(device)
    timed = dev.type == "cuda"
    recs = []
    for name, (hq, wq, hv, wv) in (PAIRS if pairs is None else pairs).items():
        for dtype in DTYPES:
            pair_recs = _probe_pair(name, (hq, wq, hv, wv), dev, dtype, card, variants, iters)
            for rec in pair_recs:
                print(json.dumps(rec), flush=True)
            recs += pair_recs
            if timed:
                torch.cuda.empty_cache()
    if timed:
        for rec in sass_records(card):
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    return recs


def _probe_pair(name: str, geometry, dev, dtype, card: str, variants, iters: int):
    """The records of the variants on one pair with the value in ``dtype``,
    and the pair's ``probe_split`` where its variants ran timed."""
    hq, wq, hv, wv = geometry
    timed = dev.type == "cuda"
    dname = str(dtype).removeprefix("torch.")
    value, _, loc, att = pair_inputs(hq, wq, hv, wv, dev, dtype)
    bound_ms, bound_by = pair_bound(hq * wq, hv * wv, value.element_size())
    base = dict(phase="probe_pair", pair=name, geometry=[[hq, wq], [hv, wv]], dtype=dname,
                bound_ms=bound_ms, bound_by=bound_by, card=card)
    recs = []
    for variant in variants:
        def kernel(variant=variant):
            return pair_probe(variant, value, loc, att, hv, wv)

        def plain(variant=variant):
            return pair_probe_plain(variant, value, loc, att, hv, wv)

        got, want = kernel(), plain()
        rec = dict(base, variant=variant,
                   jax=[j for j, v in JAX_VARIANTS.items() if v == variant],
                   max_abs_err=float((got - want).abs().max()), bound=BOUND,
                   ms=cuda_ms(kernel, iters) if timed else None,
                   plain_ms=cuda_ms(plain, iters) if timed else None,
                   library_ms=None)  # no single PyTorch call computes MSDA
        if variant == "bf16fma":  # how far the bf16 blend moves the result
            rec["max_abs_err_vs_base"] = float(
                (got - pair_probe_plain("base", value, loc, att, hv, wv)).abs().max())
            rec["bound_vs_base"] = BF16FMA_VS_BASE
        if variant == "base":  # K1 on the pair, or its plain version on the CPU
            shapes, loc1, att1 = ((hv, wv),), loc[:, :, :, None], att[:, :, :, None]
            if timed:
                from ape_tpu_torch.ops.msda_dispatch import msda_fwd_cuda

                k1 = msda_fwd_cuda(value, shapes, loc1, att1)
                rec["msda_fwd_ms"] = cuda_ms(lambda: msda_fwd_cuda(value, shapes, loc1, att1),
                                             iters)
            else:
                k1 = ms_deform_attn(value, shapes, loc1, att1)
            rec["equals_msda_fwd"] = bool(torch.equal(got.to(value.dtype).view(k1.shape), k1))
        recs.append(rec)
        del got, want
    ms = {r["variant"]: r["ms"] for r in recs}
    for rec in recs:
        rec["share_of_base"] = rec["ms"] / ms["base"] if timed and "base" in ms else None
    if timed and {"base", "no_corners", "const_w", "store_only"} <= ms.keys():
        k1_ms = next(r["msda_fwd_ms"] for r in recs if r["variant"] == "base")
        recs.append(stage_split(name, dname, ms, k1_ms, bound_ms, card))
    return recs


def failures(recs):
    """The checks a probe run failed: a variant beyond its bound, bf16fma
    beyond its bound from the exact function, or base not K1's output in
    either dtype."""
    pair = [r for r in recs if r["phase"] == "probe_pair"]
    bad = [f"{r['pair']} {r['dtype']} {r['variant']}: max |kernel - plain| {r['max_abs_err']} > "
           f"{r['bound']}" for r in pair if not r["max_abs_err"] <= r["bound"]]
    bad += [f"{r['pair']} {r['dtype']} bf16fma: max |kernel - base| {r['max_abs_err_vs_base']} > "
            f"{r['bound_vs_base']}" for r in pair
            if "bound_vs_base" in r and not r["max_abs_err_vs_base"] <= r["bound_vs_base"]]
    return bad + [f"{r['pair']} {r['dtype']} base differs from K1 on the pair" for r in pair
                  if r.get("equals_msda_fwd") is False]


def _variants(arg: str):
    if arg == "all":
        return VARIANTS
    names = [JAX_VARIANTS.get(v, v) for v in arg.split(",")]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}: the port's are {VARIANTS}, the TPU "
                         f"probe's {sorted(JAX_VARIANTS)}")
    return tuple(dict.fromkeys(names))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("pair", nargs="?", default="same", help=f"{sorted(PAIRS)} or all")
    parser.add_argument("variants", nargs="?", default=",".join(DEFAULT_VARIANTS),
                        help="comma list of variants (the port's or the TPU probe's), or all")
    parser.add_argument("--iters", type=int, default=20, help="timed calls per measurement")
    args = parser.parse_args()
    if args.pair != "all" and args.pair not in PAIRS:
        raise SystemExit(f"unknown pair {args.pair!r}: pairs are {sorted(PAIRS)} or all")
    pairs = PAIRS if args.pair == "all" else {args.pair: PAIRS[args.pair]}
    variants = _variants(args.variants)
    if not torch.cuda.is_available():
        raise SystemExit("pair_probe times the CUDA kernels: it needs an NVIDIA card")
    card = card_line()
    print(card, flush=True)
    bad = failures(probe("cuda", card, pairs, variants, args.iters))
    if bad:
        raise SystemExit("; ".join(bad))


if __name__ == "__main__":
    main()
