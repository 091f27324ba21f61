"""Race the encoder's window-MSDA forward forms on one CUDA card, from the
root of a checkout:

    python3 -m ape_tpu_torch.tools.msda_race [--iters N]

The counterpart of the JAX repository's ``experiments/full_op_race.py``,
``pair_suite.py`` and ``pair_suite_v6.py``. It times one encoder layer's
window-MSDA forward (APE-Ti: 8 heads of width 32, 4 points, radius 4, bf16)
under each form of ``ops/msda_window_forms.py``: K1 (``gather``, with its
torch-side clip), K6 over all pairs (``pair``), K7 with its finer pairs on
K6 (``rows``), K8 (``qlevel``) and K9 with the narrow query levels on K1
(``dense``); at the protocol pyramid (128^2 ... 8^2, batch 1, S 21,824) and
the 4-scale training pyramid (256^2 ... 16^2, batch 2, S 87,296); under two
offset draws: ``ring`` (the ring init plus 1.5 N(0, 1) pixels, as
``chip_smoke.py`` draws them) and ``randn2`` (2 N(0, 1) pixels, JAX's
``full_op_race.py`` at its default OFF_SCALE). Then per-pair times: K6 for
every pair of the 4-scale pyramid, as ``pair_suite.py``; K9 beside K1 for
the pairs of the 128-wide query levels, as ``pair_suite_v6.py``; and K1 on
every pair. Last, where K8's D = 32 body spends its time (ring draw): the
device time (``device_ms``) of the whole op and of each query level's launch, for the op
and for its parts (``msda_window_forms.D32_VARIANTS``: the staged levels'
samples alone, the finer levels' alone, the boxes staged by cp.async
instead of TMA), beside K1's window entry and K8's general body; and where
K9's D = 32 body spends its time: the device time of the whole op (its K9
launches and the K1 launch of the narrow query levels), of each K9 launch
(one a query level) and of the K1 launch, for the op and for its parts
(``msda_window_forms.DENSE_D32_VARIANTS``: the box levels alone, the finer
levels alone, the box levels without the products, their staging alone),
beside K1's window entry and K9's general body.

Each line is one JSON record with the form's launches per layer, its bound
(the bytes it must move over 3.35 TB/s: value, offsets, weights and output
once) and the card's name and power limit. Times are CUDA events over
``iters`` calls after one warm-up. K1 is also timed on every pair alone, so
each pair has a measured winner. ``chip_smoke.py`` calls ``race`` as a
phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ape_tpu_torch.layers.msda_module import _offset_bias_init
from ape_tpu_torch.ops import _build
from ape_tpu_torch.ops import msda_window_forms as forms
from ape_tpu_torch.ops.msda import level_start_index
from ape_tpu_torch.ops.msda_dispatch import msda_fwd_cuda, msda_fwd_window_cuda, window_locations

HEADS, HEAD_DIM, POINTS, RADIUS = 8, 32, 4, 4
PYRAMIDS = {"protocol": (((128, 128), (64, 64), (32, 32), (16, 16), (8, 8)), 1),
            "four_scale": (((256, 256), (128, 128), (64, 64), (32, 32), (16, 16)), 2)}
DRAWS = ("ring", "randn2")
OFF_SCALE = 2.0  # full_op_race.py's default
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FORM_KERNELS = {"gather": "K1", "pair": "K6", "rows": "K7 + K6", "qlevel": "K8",
                "dense": "K9 + K1"}
SEED = 0


def window_inputs(g: torch.Generator, shapes, batch: int, draw: str, dtype, dev):
    """Seeded inputs of one encoder layer's window MSDA: value (B, S, H, D)
    and attention weights (softmax over levels and points) in dtype, pixel
    offsets (B, S, H, L, P, 2) f32, all on dev."""
    s, levels = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(batch, s, HEADS, HEAD_DIM, generator=g)
    noise = torch.randn(batch, s, HEADS, levels, POINTS, 2, generator=g)
    if draw == "ring":
        ring = torch.from_numpy(_offset_bias_init(HEADS, levels, POINTS)).view(HEADS, levels,
                                                                                 POINTS, 2)
        off = ring[None, None] + 1.5 * noise
    elif draw == "randn2":
        off = OFF_SCALE * noise
    else:
        raise ValueError(f"unknown offset draw {draw!r}; draws are {DRAWS}")
    att = torch.softmax(torch.randn(batch, s, HEADS, levels * POINTS, generator=g), -1)
    att = att.view(batch, s, HEADS, levels, POINTS)
    return value.to(dev, dtype), off.to(dev).contiguous(), att.to(dev, dtype)


def bound_ms(batch: int, queries: int, values: int, levels: int, esize: int) -> float:
    """Least time of a window MSDA over ``queries`` rows reading ``values``
    pixels: value, offsets (f32), weights and output once at 3.35 TB/s; its
    arithmetic (about 8 flops a byte) never bounds it."""
    nbytes = batch * HEADS * (values * HEAD_DIM * esize + queries * levels * POINTS * (8 + esize)
                              + queries * HEAD_DIM * esize)
    return nbytes / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms, by CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time of fn()'s launches per call, run back to back: after a
    warm-up a spin kernel (``torch.cuda._sleep``) holds the stream while
    the host enqueues ``iters`` calls between two CUDA events, so the host's
    time between launches does not count, as it does in ``cuda_ms`` for a
    launch shorter than its call. The hold grows until the host is done
    before the first event is reached. (``torch.profiler``'s device time,
    which ``chip_smoke.kernel_ms`` reads, came back with some kernels
    missing late in a long process on an H100: 0.020 ms for K1's window
    entry, whose events read 0.206.)"""
    fn()
    torch.cuda.synchronize()
    hold = 10_000_000  # clock cycles, about 5 ms
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()  # the stream was still held when the last call was enqueued
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        hold *= 4
    raise RuntimeError("device_ms: the host did not enqueue the calls within the hold")


def qlevel_parts(value, shapes, off, att, iters: int, card: str, base: dict):
    """Records of K8's D = 32 body by its parts: for each variant, the
    device time of the whole op (its plan's launches) and of each query
    level's launch; K1's window entry and K8's general body beside."""
    plan = forms.plan_layer("qlevel", shapes, HEAD_DIM, value.element_size(), RADIUS)
    out = torch.empty(*value.shape[:2], HEADS * HEAD_DIM, dtype=value.dtype, device=value.device)

    def run(launches, variant):
        return lambda: [forms.launch_cuda(x, value, shapes, off, att, out, RADIUS, variant)
                        for x in launches]

    recs = [dict(base, body="general", device_ms=device_ms(lambda: forms.window_form_cuda(
                "qlevel", value, shapes, off, att, RADIUS, body="general"), iters), card=card),
            dict(base, kernel="msda_fwd_window", device_ms=device_ms(
                lambda: msda_fwd_window_cuda(value, shapes, off, att, RADIUS), iters), card=card)]
    for variant in forms.D32_VARIANTS:
        recs.append(dict(base, body="d32", variant=variant, device_ms=device_ms(run(plan, variant),
                                                                                iters),
                         per_query_level_ms=[device_ms(run([x], variant), iters) for x in plan],
                         tiles=[list(x.tile) for x in plan], smem=[x.smem for x in plan],
                         card=card))
    return recs


def dense_parts(value, shapes, off, att, iters: int, card: str, base: dict):
    """Records of K9's D = 32 body by its parts: for each variant, the
    device time of the plan's K9 launches and of each of them (one a query
    level), and the K1 launch of the narrow query levels; the whole op
    under the D = 32 body and under the general body, and K1's window entry,
    beside."""
    plan = forms.plan_layer("dense", shapes, HEAD_DIM, value.element_size(), RADIUS)
    dense = [x for x in plan if x.kernel == "msda_fwd_dense"]
    k1 = [x for x in plan if x.kernel == "msda_fwd"]
    out = torch.empty(*value.shape[:2], HEADS * HEAD_DIM, dtype=value.dtype, device=value.device)
    starts, _ = level_start_index(shapes)

    def run(launches, variant):
        return lambda: [forms.launch_cuda(x, value, shapes, off, att, out, RADIUS, variant)
                        for x in launches]

    def k1_run(x):
        first, last = x.query_levels[0], x.query_levels[-1]
        rows = slice(starts[first], starts[last] + shapes[last][0] * shapes[last][1])
        loc = window_locations(shapes, off[:, rows], RADIUS, first_query=rows.start).contiguous()
        att_rows = att[:, rows].contiguous()
        return lambda: msda_fwd_cuda(value, shapes, loc, att_rows)

    recs = [dict(base, body=body, kernel="msda_fwd_dense", device_ms=device_ms(
                lambda body=body: forms.window_form_cuda("dense", value, shapes, off, att, RADIUS,
                                                         body=body), iters), card=card)
            for body in ("d32", "general")]
    recs.append(dict(base, kernel="msda_fwd_window", device_ms=device_ms(
        lambda: msda_fwd_window_cuda(value, shapes, off, att, RADIUS), iters), card=card))
    recs.append(dict(base, kernel="msda_fwd", query_levels=[list(x.query_levels) for x in k1],
                     device_ms=[device_ms(k1_run(x), iters) for x in k1], card=card))
    for variant in forms.DENSE_D32_VARIANTS:
        recs.append(dict(base, body="d32", variant=variant,
                         device_ms=device_ms(run(dense, variant), iters),
                         per_query_level_ms=[device_ms(run([x], variant), iters) for x in dense],
                         query_levels=[x.query_levels[0] for x in dense],
                         tiles=[list(x.tile) for x in dense], smem=[x.smem for x in dense],
                         card=card))
    return recs


def form_op(form: str, value, shapes, off, att):
    """The whole window op under a form, as a callable."""
    if form == "gather":
        return lambda: msda_fwd_cuda(value, shapes, window_locations(shapes, off, RADIUS)
                                     .contiguous(), att)
    return lambda: forms.window_form_cuda(form, value, shapes, off, att, RADIUS)


def _launches(fn):
    """fn()'s result and the kernel launches it made."""
    before = dict(_build.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}


def _pairs(value, shapes, off, att, batch, esize, iters, card, base):
    """Per-pair records: K1 on every pair (its locations and weights cut to
    the pair beforehand), K6 on every pair of the 4-scale pyramid, K9 on the
    pairs of the 128-wide query levels."""
    starts, s = level_start_index(shapes)
    c = HEADS * HEAD_DIM
    loc = window_locations(shapes, off, RADIUS)
    buf = torch.zeros(batch, s, c, dtype=torch.float32, device=value.device)
    out = torch.empty(batch, s, c, dtype=value.dtype, device=value.device)
    recs = []
    for lq, (hq, wq) in enumerate(shapes):
        rows = slice(starts[lq], starts[lq] + hq * wq)
        for lv, (hv, wv) in enumerate(shapes):
            pair = dict(base, pair=[[hq, wq], [hv, wv]],
                        bound_ms=bound_ms(batch, hq * wq, hv * wv, 1, esize), card=card)
            times = {}
            if base["pyramid"] == "four_scale":
                k6 = forms.single_launch("msda_fwd_pair", shapes, lq, [lv], HEAD_DIM, esize,
                                         RADIUS, "store")
                times["K6"] = cuda_ms(lambda: forms.launch_cuda(k6, value, shapes, off, att, buf,
                                                                RADIUS), iters)
            if wq % forms.DENSE_WIDTH == 0:
                k9 = forms.single_launch("msda_fwd_dense", shapes, lq, [lv], HEAD_DIM, esize,
                                         RADIUS)
                times["K9"] = cuda_ms(lambda: forms.launch_cuda(k9, value, shapes, off, att, out,
                                                                RADIUS), iters)
            v_l = value[:, starts[lv]:starts[lv] + hv * wv].contiguous()
            loc_p = loc[:, rows, :, lv:lv + 1].contiguous()
            att_p = att[:, rows, :, lv:lv + 1].contiguous()
            times["K1"] = cuda_ms(lambda: msda_fwd_cuda(v_l, ((hv, wv),), loc_p, att_p), iters)
            recs.append(dict(pair, ms=times))
    return recs


def race(dev, card: str, iters: int = 20):
    """Time every form at both pyramids and both offset draws, in bf16, and
    the per-pair suites; each form is checked against K1 on the same inputs.
    Prints each record as a JSON line and returns them."""
    g = torch.Generator().manual_seed(SEED)
    recs = []
    for pyramid, (shapes, batch) in PYRAMIDS.items():
        s = sum(h * w for h, w in shapes)
        for draw in DRAWS:
            value, off, att = window_inputs(g, shapes, batch, draw, torch.bfloat16, dev)
            esize = value.element_size()
            base = dict(phase="race", pyramid=pyramid, batch=batch, tokens=s, draw=draw,
                        dtype="bfloat16")
            bound = bound_ms(batch, s, s, len(shapes), esize)
            gather = form_op("gather", value, shapes, off, att)()
            for form in forms.FORMS:
                op = form_op(form, value, shapes, off, att)
                got, launches = _launches(op)
                rec = dict(base, form=form, kernels=FORM_KERNELS[form], ms=cuda_ms(op, iters),
                           launches_per_layer=launches, bound_ms=bound,
                           max_abs_diff_vs_k1=float((got.float() - gather.float()).abs().max()),
                           card=card)
                print(json.dumps(rec), flush=True)
                recs.append(rec)
            parts = []
            if draw == "ring":
                parts = (qlevel_parts(value, shapes, off, att, iters, card,
                                      dict(base, phase="race_qlevel"))
                         + dense_parts(value, shapes, off, att, iters, card,
                                       dict(base, phase="race_dense")))
            for rec in _pairs(value, shapes, off, att, batch, esize, iters, card,
                              dict(base, phase="race_pair")) + parts:
                print(json.dumps(rec), flush=True)
                recs.append(rec)
            del value, off, att, gather
            torch.cuda.empty_cache()
    return recs


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20, help="timed calls per measurement")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("msda_race times the CUDA kernels: it needs an NVIDIA card")
    card = card_line()
    print(card, flush=True)
    race(torch.device("cuda", 0), card, args.iters)


if __name__ == "__main__":
    main()
