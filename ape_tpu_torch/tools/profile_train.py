"""Profile one APE-Ti train step in ``chip_smoke.py``'s train configuration
(1024^2, batch 2, 300 queries, bf16, recompute checkpointing) on one CUDA
card, from the root of a checkout:

    python3 -m ape_tpu_torch.tools.profile_train [--masked]

Without flags the detection model (chip_smoke's phase 8); ``--masked`` the
full masked model with the mask losses (phase 11). Under
``APE_MSDA_BWD_MERGED=0`` the encoder's MSDA backward runs on the split
kernels (K3 + K4) instead of K2; under ``APE_MSDA_FUSED=1`` (K8) or
``APE_MSDA_V6=1`` (K9 + K1) its forward takes another form.

Prints three JSON lines and the card's nvidia-smi line:

* ``stage_split``: three steps timed by CUDA events: forward with the loss,
  backward (recompute included), clip with the optimizer step, and the
  forward of the backbone, neck, encoder, decoder and, with a mask head,
  the pixel decoder (lateral conv to mask conv);
* ``profile``: one step under ``torch.profiler``: device busy time (the
  union of kernel intervals) against the step's wall time, kernel and launch
  counts, and the top kernels by summed device time;
* ``kernels``: the port's own kernels' launches and summed device time in
  that step, [count, ms] by name.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

import chip_smoke as cs
from ape_tpu_torch.engine.optimizer import build_optimizer
from ape_tpu_torch.engine.train_step import loss_fn, make_train_step
from ape_tpu_torch.modeling.build import build_ape_ti
from ape_tpu_torch.ops import msda_dispatch

PORT_KERNELS = ("msda_fwd_kernel", "msda_fwd_qlevel", "msda_fwd_dense", "msda_bwd_kernel",
                "msda_bwd_offatt", "msda_bwd_value", "attn_fwd", "attn_bwd")


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def stage_split(model, crit, opt, sched, batch, gen, steps: int = 3):
    parts = {"backbone": model.backbone, "neck": model.neck,
             "encoder": model.transformer.encoder, "decoder": model.transformer.decoder}
    splits = []
    for _ in range(steps):
        marks = {}
        spans = {n: (m, m) for n, m in parts.items()}
        if model.mask_on:
            spans["pixel_decoder"] = (model.lateral_conv, model.mask_conv)
        hooks = [m.register_forward_pre_hook(lambda *_, n=n: marks.__setitem__(n + "0", _event()))
                 for n, (m, _) in spans.items()]
        hooks += [m.register_forward_hook(lambda *_, n=n: marks.__setitem__(n + "1", _event()))
                  for n, (_, m) in spans.items()]
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        ev = [_event()]
        total, _, _ = loss_fn(model, crit, batch, gen)
        ev.append(_event())
        for h in hooks:
            h.remove()
        total.backward()
        ev.append(_event())
        torch.nn.utils.clip_grad_norm_(list(model.parameters()), 0.1)
        opt.step()
        sched.step()
        ev.append(_event())
        torch.cuda.synchronize()
        splits.append(dict(
            wall_ms=(time.perf_counter() - t0) * 1e3,
            forward_and_loss_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
            optimizer_ms=ev[2].elapsed_time(ev[3]),
            forward_modules_ms={n: marks[n + "0"].elapsed_time(marks[n + "1"]) for n in spans}))
    return splits


def profile_call(fn, top_n: int = 25):
    """fn() once under torch.profiler: (its wall time, device busy time (the
    union of kernel intervals) and share of the wall, kernel and launch
    counts, the top_n kernels by summed device time; the port's own
    kernels' summed device time by PORT_KERNELS)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # device events, less the user ranges drawn on the device timeline
    # (``Optimizer.step#AdamW.step``): those span idle gaps
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_us, cur = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if cur is None or s > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += 0 if cur is None else cur[1] - cur[0]
    by_name = {}
    for e in kern:
        d = by_name.setdefault(e.name[:90], [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us() / 1e3
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
                   for e in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    ours = {k: [sum(c for n, (c, _) in by_name.items() if k in n),
                sum(ms for n, (_, ms) in by_name.items() if k in n)] for k in PORT_KERNELS}
    return (dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                 busy_share_of_wall=busy_us / 1e3 / wall_ms, kernels=len(kern),
                 launch_calls=launches, top=[[n, c, ms] for n, (c, ms) in top]), ours)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--masked", action="store_true", help="the full masked model")
    args = parser.parse_args()
    cs.device_phase()
    dev = torch.device("cuda", 0)
    model = build_ape_ti(num_queries=cs.TRAIN_QUERIES, window_radius=cs.RADIUS, mask_on=args.masked,
                         use_act_checkpoint=True, dtype=torch.bfloat16, device=dev)
    model = cs.init_weights(model, cs.SEED)
    crit = cs._criterion(cs.TRAIN_QUERIES, args.masked)
    opt, sched = build_optimizer(model)
    step = make_train_step(model, crit, opt, sched)
    batch = cs._train_batch(dev, cs.TRAIN_BATCH, cs.TRAIN_IMG, cs.SEED + 4, masks=args.masked)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for _ in range(2):
        step(batch, gen)
    torch.cuda.synchronize()
    print(json.dumps({"form": {"masked": args.masked, "split": not msda_dispatch.BWD_MERGED,
                               "window_forward": msda_dispatch.window_form(8)}}), flush=True)
    print(json.dumps({"stage_split": stage_split(model, crit, opt, sched, batch, gen)}), flush=True)
    prof, ours = profile_call(lambda: step(batch, gen))
    print(json.dumps({"profile": prof}), flush=True)
    print(json.dumps({"kernels": ours}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
