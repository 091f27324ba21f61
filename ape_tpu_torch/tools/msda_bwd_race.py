"""Race the encoder's window-MSDA backward forms on one CUDA card, from the
root of a checkout:

    python3 -m ape_tpu_torch.tools.msda_bwd_race [--iters N]

The backward counterpart of ``tools/msda_race.py`` and of the JAX
repository's ``experiments/encoder_bwd_race.py``. It times one encoder
layer's window-MSDA backward (APE-Ti: 8 heads of width 32, 4 points, radius
4, bf16, the gradient of the whole output) under each form:

  * ``merged``: K2, ``csrc/msda_bwd.cu`` (d_value, d_loc, d_att in one
    launch);
  * ``split``: K3 + K4, ``csrc/msda_bwd_split.cu`` (d_loc and d_att, then
    d_value), the form ``msda_dispatch.BWD_MERGED = False`` selects;
  * ``plain``: torch autograd of the plain version, ``ops.msda``;

at the protocol pyramid (128^2 ... 8^2, batch 1, S 21,824) and the 4-scale
training pyramid (256^2 ... 16^2, batch 2, S 87,296), under ``msda_race``'s
two offset draws (``ring``: the ring init plus 1.5 N(0, 1) pixels;
``randn2``: 2 N(0, 1) pixels). The locations are the clipped ones the
forward samples at (``window_locations``).

Each line is one JSON record: the form, the median, least and largest time
of ``iters`` calls (CUDA events around each call, after one warm-up), the
launches of one call, the bound (``bound_ms``: the bytes the form must move
at 3.35 TB/s or its f32 sample arithmetic at 67 TFLOP/s, the larger), each
output's error over its largest entry (merged against the plain version,
split against merged) and the card's name and power limit. ``failures``
holds the errors over their bf16 bounds (``ops/bounds.py``); ``chip_smoke.py``
calls ``race`` in its race phase. ``device="cpu"`` runs the plain version
in every form's place, untimed, to test the plumbing.

On the card, under the ring draw, ``value_parts`` adds where K4's time goes:
the device time of its D = 32 body and of its general body with every
value level's samples live, and of the D = 32 body with one value level's
samples live at a time (the others' locations NaN, which the kernel drops),
beside K2.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ape_tpu_torch.ops.bounds import GRAD_BOUNDS, SPLIT_BOUNDS
from ape_tpu_torch.ops.msda import ms_deform_attn
from ape_tpu_torch.ops.msda_dispatch import (
    msda_bwd_cuda,
    msda_bwd_offatt_cuda,
    msda_bwd_value_cuda,
    window_locations,
)
from ape_tpu_torch.tools.msda_race import (
    DRAWS,
    HBM_BYTES_PER_S,
    HEAD_DIM,
    HEADS,
    POINTS,
    PYRAMIDS,
    RADIUS,
    _launches,
    card_line,
    device_ms,
    window_inputs,
)
from ape_tpu_torch.tools.pair_probe import PEAK_F32_FLOPS, device_or_card

SEED = 0
FORMS = {"merged": "K2", "split": "K3 + K4", "plain": "autograd of the plain version"}
OUTPUTS = ("d_value", "d_loc", "d_att")
# f32 flops a (sample, channel) of either form: the forward's 10 (corners and
# weight), the three dot products and the four scatters (chip_smoke.py's
# MSDA_SAMPLE_FLOPS: K2 26, K3 22 and K4 4)
SAMPLE_FLOPS = 26


def bound(form: str, batch: int, tokens: int, levels: int, esize: int):
    """(bound_ms, bound_by) of one encoder layer's backward (queries = value
    tokens): value, locations (f32), weights and grad read once, d_value,
    d_loc (f32) and d_att written once; split reads the locations, weights
    and grad twice, once for each kernel, and the value once."""
    value = batch * tokens * HEADS * HEAD_DIM * esize
    samples = batch * tokens * HEADS * levels * POINTS
    loc, att = samples * 8, samples * esize
    reads = value + loc + att + value  # value, loc, att and the grad (as wide as the value)
    if form == "split":
        reads += loc + att + value
    nbytes = reads + value + loc + att
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = samples * HEAD_DIM * SAMPLE_FLOPS / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def call_times(fn, iters: int, cuda: bool):
    """fn()'s time in ms for each of ``iters`` calls after one warm-up: CUDA
    events around each call on the card, None each on the CPU."""
    fn()
    if not cuda:
        return [None] * iters
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def _rel_errors(got, want):
    return {n: float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
            for n, g, w in zip(OUTPUTS, got, want)}


def race(device=None, card: str | None = None, iters: int = 10, pyramids=PYRAMIDS,
         draws=DRAWS):
    """Time every form at each pyramid and offset draw, in bf16; merged held
    against the plain version, split against merged. Prints each record as a
    JSON line and returns them."""
    dev = device_or_card(device)
    cuda = dev.type == "cuda"
    if card is None:
        card = card_line() if cuda else "cpu"
    g = torch.Generator().manual_seed(SEED)
    recs = []
    for pyramid, (shapes, batch) in pyramids.items():
        s = sum(h * w for h, w in shapes)
        for draw in draws:
            value, off, att = window_inputs(g, shapes, batch, draw, torch.bfloat16, dev)
            loc = window_locations(shapes, off, RADIUS).contiguous()
            grad = torch.randn(batch, s, HEADS * HEAD_DIM, generator=g).to(dev, torch.bfloat16)
            leaves = [t.detach().clone().requires_grad_() for t in (value, loc, att)]
            out = ms_deform_attn(leaves[0], shapes, *leaves[1:])

            def plain():
                return torch.autograd.grad(out, leaves, grad, retain_graph=True)

            def merged():
                return msda_bwd_cuda(value, shapes, loc, att, grad) if cuda else plain()

            def split():
                if not cuda:
                    return plain()
                d_loc, d_att = msda_bwd_offatt_cuda(value, shapes, loc, att, grad)
                return msda_bwd_value_cuda(shapes, loc, att, grad), d_loc, d_att

            fns = {"merged": merged, "split": split, "plain": plain}
            got = {}
            base = dict(phase="bwd_race", pyramid=pyramid, batch=batch, tokens=s, draw=draw,
                        dtype="bfloat16", iters=iters, card=card)
            for form, fn in fns.items():
                got[form], launches = _launches(fn)
                times = call_times(fn, iters, cuda)
                rec = dict(base, form=form, kernels=FORMS[form], launches=launches,
                           median_ms=statistics.median(times) if cuda else None,
                           min_ms=min(times) if cuda else None,
                           max_ms=max(times) if cuda else None)
                if form != "plain":
                    rec["bound_ms"], rec["bound_by"] = bound(form, batch, s, len(shapes),
                                                             value.element_size())
                recs.append(rec)
            recs[-3]["rel_err_vs_plain"] = _rel_errors(got["merged"], got["plain"])
            recs[-2]["rel_err_vs_merged"] = _rel_errors(got["split"], got["merged"])
            for rec in recs[-3:]:
                print(json.dumps(rec), flush=True)
            if cuda and draw == "ring":
                for rec in value_parts(shapes, value, loc, att, grad, iters,
                                       dict(base, phase="bwd_race_value")):
                    print(json.dumps(rec), flush=True)
                    recs.append(rec)
            del value, off, att, loc, grad, leaves, out, got
            if cuda:
                torch.cuda.empty_cache()
    return recs


def value_parts(shapes, value, loc, att, grad, iters: int, base: dict) -> list:
    """Records of K4 by its parts (device time, ``msda_race.device_ms``): its
    D = 32 body and its general body over every value level, K2 beside; the
    D = 32 body with only one value level's samples live, for each level."""
    recs = [dict(base, kernel="msda_bwd_value", body=body, value_levels="all",
                 device_ms=device_ms(lambda body=body: msda_bwd_value_cuda(
                     shapes, loc, att, grad, body=body), iters))
            for body in ("d32", "general")]
    recs.append(dict(base, kernel="msda_bwd", value_levels="all",
                     device_ms=device_ms(lambda: msda_bwd_cuda(value, shapes, loc, att, grad),
                                         iters)))
    for lv, size in enumerate(shapes):
        one = loc.clone()
        one[:, :, :, [i for i in range(len(shapes)) if i != lv]] = float("nan")
        recs.append(dict(base, kernel="msda_bwd_value", body="d32", value_levels=[lv],
                         value_level_shape=list(size),
                         device_ms=device_ms(lambda one=one: msda_bwd_value_cuda(
                             shapes, one, att, grad, body="d32"), iters)))
    return recs


def failures(recs) -> list:
    """Each form's error over its bf16 bound (each output over its own
    largest entry: merged against the plain version, split against merged),
    one string each."""
    bad = []
    for rec in recs:
        for key, limit in (("rel_err_vs_plain", GRAD_BOUNDS["bfloat16"]),
                           ("rel_err_vs_merged", SPLIT_BOUNDS["bfloat16"])):
            for name, err in rec.get(key, {}).items():
                if not err <= limit:
                    bad.append(f"{rec['form']} {rec['pyramid']} {rec['draw']}: {name} {key} "
                               f"{err} > {limit}")
    return bad


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10, help="timed calls per form")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("msda_bwd_race times the CUDA kernels: it needs an NVIDIA card")
    card = card_line()
    print(card, flush=True)
    bad = failures(race(card=card, iters=args.iters))
    if bad:
        raise SystemExit("; ".join(bad))


if __name__ == "__main__":
    main()
