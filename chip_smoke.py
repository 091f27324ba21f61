#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ape_tpu_torch``) of APE-Ti on one NVIDIA
card, from the root of a checkout: protocol inference, then training.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi's own line too);
2. build: compile ``ape_tpu_torch/csrc/*.cu`` into ``build/ape_tpu_torch/``;
3. kernels: each forward CUDA kernel against its plain PyTorch version at the
   shapes the main paths give it, in f32 (TF32 off) and bf16, with times;
4. backward kernels: each backward kernel against torch autograd of its
   plain version at the training shapes, in f32 and bf16, with times;
5. slice: ``build_ape_ti`` at the reference latency protocol (1024^2, bf16,
   900 queries, 80 text features of width 1024, N(0, 0.02) weights with the
   ring-init offsets re-armed): launch counts per forward, host syncs,
   output checks, images/s;
6. serve: ``DefaultPredictor`` answers three non-square requests;
7. f32: the same forward in f32 held against the plain versions on the CPU;
8. train: APE-Ti training as ``tools/bench_train.py`` runs it without masks
   (1024^2, batch 2, 300 queries, default pyramid, bf16 over f32 params,
   recompute checkpointing, 80 texts, 8 target slots with 4 valid), through
   ``build_optimizer`` and ``make_train_step``: one warm-up step, three timed
   steps; finite losses and gradients, launches per step, s/step, memory;
9. train f32: one f32 step at 512^2, batch 1, protocol pyramid, fan-in
   weights: every parameter's gradient held against the plain versions on
   the CPU, and the plain gradients' own floor under a perturbation of the
   images at f32 rounding size.

Then the kernels line and, last, {"ok": true, "device": {...}}. The script
needs the repository around it and a CUDA card; it imports no JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
import warnings
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
IMG = 1024
NUM_TEXT = 80
QUERIES = 900
SHAPES = ((128, 128), (64, 64), (32, 32), (16, 16), (8, 8))  # protocol pyramid at 1024^2
HEADS, HEAD_DIM, POINTS, RADIUS = 8, 32, 4, 4
# |kernel - plain| bounds. f32: both accumulate in f32 in another order. bf16:
# the output is rounded to bf16 (8 bits) at magnitudes up to ~4, so one ulp.
BOUNDS = {"float32": {"msda": 1e-5, "attn": 1e-4}, "bfloat16": {"msda": 3.2e-2, "attn": 3.2e-2}}
# Backward kernels, for each output on its own (d_value, d_loc, d_att; dK,
# dV; dQ): max |kernel - autograd of plain| over that output's max |plain|.
# f32: sums in another order, d_value by atomics in a run-dependent order.
# bf16: both sides see the same bf16 inputs (plain upcast to f32); the
# kernel's gradients are rounded to bf16 (2^-8 relative) where the inputs are
# bf16.
GRAD_BOUNDS = {"float32": 1e-4, "bfloat16": 1e-2}
MEMORY_BOUND = 1e-3  # f32 encoder memory, CUDA kernels vs plain on the CPU
SEED = 0

TRAIN_IMG, TRAIN_BATCH, TRAIN_QUERIES, TRAIN_STEPS = 1024, 2, 300, 3
TRAIN_SHAPES = ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16))  # default pyramid at 1024^2
# Launches per train step with every encoder and decoder layer recomputed in
# the backward: 6 + 6 MSDA forwards, again in the recompute, one backward
# each; the backbone (not recomputed) runs 4 global blocks once each way.
STEP_LAUNCHES = {"msda_fwd": 24, "msda_bwd": 12, "attn_fwd": 4,
                 "attn_bwd_delta": 4, "attn_bwd_dkv": 4, "attn_bwd_dq": 4}
F32_TRAIN_IMG = 512
# f32 train step, CUDA kernels vs plain on the CPU: per parameter, max |diff|
# over max |CPU gradient|, bound about 3x the <= 5.1e-3 these read on the
# H100. The sampling_offsets leaves get more: d_loc is one-sided at integer
# pixels and the window clip has edges, so a sample that rounding moves
# across one changes their gradient by a step. The phase measures that floor
# every run: the plain version against itself with the images perturbed by
# PERTURB relative (f32 rounding size). It read 1.8e-2 at an encoder layer's
# sampling_offsets. A missing detach or a wrong kernel term moves gradients
# by O(1).
F32_GRAD_RTOL = 1.5e-2
F32_OFFSET_GRAD_RTOL = 5e-2
PERTURB = 1e-7


def log(**rec):
    print(json.dumps(rec), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_phase():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(phase="device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi.splitlines()[0],
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi.splitlines()[0]


def build_phase():
    from ape_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(phase="build", seconds=time.perf_counter() - t0, library=str(lib.relative_to(ROOT)))


def _ring(levels: int):
    import torch

    from ape_tpu_torch.layers.msda_module import _offset_bias_init

    return torch.from_numpy(_offset_bias_init(HEADS, levels, POINTS)).view(HEADS, levels, POINTS, 2)


def kernels_phase(dev):
    """Kernel against plain version at main-path shapes; returns per-kernel
    results at the main path's dtype (bf16)."""
    import torch

    from ape_tpu_torch.ops.attention import attn_fwd_cuda, global_attention_plain
    from ape_tpu_torch.ops.msda import ms_deform_attn
    from ape_tpu_torch.ops.msda_dispatch import msda_fwd_cuda, window_locations

    g = torch.Generator().manual_seed(SEED)
    s = sum(h * w for h, w in SHAPES)
    lv = len(SHAPES)
    value32 = torch.randn(1, s, HEADS, HEAD_DIM, generator=g)
    att32 = torch.softmax(torch.randn(1, s, HEADS, lv * POINTS, generator=g), -1)
    # encoder: ring-init offsets (radius p + 1 px) plus learned-scale noise, clipped to R
    off = _ring(lv)[None, None] + 1.5 * torch.randn(1, s, HEADS, lv, POINTS, 2, generator=g)
    enc_loc = window_locations(SHAPES, off.to(dev), RADIUS).contiguous()
    # decoder: 900 box references, loc = ref + off / P * wh * 0.5
    refs = torch.cat([0.1 + 0.8 * torch.rand(1, QUERIES, 1, 2, generator=g),
                      0.02 + 0.3 * torch.rand(1, QUERIES, 1, 2, generator=g)], -1)
    doff = _ring(lv)[None, None] + torch.randn(1, QUERIES, HEADS, lv, POINTS, 2, generator=g)
    dec_loc = (refs[:, :, None, :, None, :2]
               + doff / POINTS * refs[:, :, None, :, None, 2:] * 0.5).to(dev).contiguous()
    datt32 = torch.softmax(torch.randn(1, QUERIES, HEADS, lv * POINTS, generator=g), -1)
    qkv32 = [torch.randn(1, 3, 4096, 64, generator=g) for _ in range(3)]

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        value = value32.to(dev, dtype)
        enc_att = att32.view(1, s, HEADS, lv, POINTS).to(dev, dtype)
        dec_att = datt32.view(1, QUERIES, HEADS, lv, POINTS).to(dev, dtype)
        q, k, v = (t.to(dev, dtype) for t in qkv32)
        cases = {
            "msda_encoder": (lambda: msda_fwd_cuda(value, SHAPES, enc_loc, enc_att),
                             lambda: ms_deform_attn(value, SHAPES, enc_loc, enc_att), "msda"),
            "msda_decoder": (lambda: msda_fwd_cuda(value, SHAPES, dec_loc, dec_att),
                             lambda: ms_deform_attn(value, SHAPES, dec_loc, dec_att), "msda"),
            "attention": (lambda: attn_fwd_cuda(q, k, v, 64**-0.5),
                          lambda: global_attention_plain(q, k, v, 64**-0.5), "attn"),
        }
        for name, (kernel, plain, kind) in cases.items():
            err = float((kernel().float() - plain().float()).abs().max())
            bound = BOUNDS[dname][kind]
            rec = dict(phase="kernel", name=name, dtype=dname, max_abs_err=err, bound=bound,
                       ms=cuda_ms(kernel), plain_ms=cuda_ms(plain))
            log(**rec)
            if not err <= bound:
                fail(f"{name} {dname}: max |kernel - plain| {err} > {bound}")
            results[(name, dname)] = rec
    return results


def _errors(names, got, want):
    """{output: (max |got - want|, that over max |want|)}, each output on its own."""
    out = {}
    for n, g, w in zip(names, got, want):
        err = float((g.float() - w.float()).abs().max())
        out[n] = (err, err / max(float(w.abs().max()), 1e-30))
    return out


def backward_kernels_phase(dev):
    """Each backward kernel against torch autograd of its plain version at the
    training shapes: errors against the plain version in f32 on the same
    inputs, times against the plain backward in the same dtype. Returns
    per-case results at bf16."""
    import torch

    from ape_tpu_torch.ops.attention import (
        attn_bwd_delta_cuda,
        attn_bwd_dkv_cuda,
        attn_bwd_dq_cuda,
        attn_fwd_cuda,
        global_attention_plain,
    )
    from ape_tpu_torch.ops.msda import ms_deform_attn
    from ape_tpu_torch.ops.msda_dispatch import msda_bwd_cuda, window_locations

    g = torch.Generator().manual_seed(SEED + 3)
    b, s, lv = TRAIN_BATCH, sum(h * w for h, w in TRAIN_SHAPES), len(TRAIN_SHAPES)
    value32 = torch.randn(b, s, HEADS, HEAD_DIM, generator=g)
    off = _ring(lv)[None, None] + 1.5 * torch.randn(b, s, HEADS, lv, POINTS, 2, generator=g)
    refs = torch.cat([0.1 + 0.8 * torch.rand(b, TRAIN_QUERIES, 1, 2, generator=g),
                      0.02 + 0.3 * torch.rand(b, TRAIN_QUERIES, 1, 2, generator=g)], -1)
    doff = _ring(lv)[None, None] + torch.randn(b, TRAIN_QUERIES, HEADS, lv, POINTS, 2, generator=g)
    msda_cases = {
        "msda_bwd_encoder": window_locations(TRAIN_SHAPES, off.to(dev), RADIUS).contiguous(),
        "msda_bwd_decoder": (refs[:, :, None, :, None, :2] + doff / POINTS
                             * refs[:, :, None, :, None, 2:] * 0.5).to(dev).contiguous(),
    }
    atts = {n: torch.softmax(torch.randn(b, l.shape[1], HEADS, lv * POINTS, generator=g), -1)
            .view(b, l.shape[1], HEADS, lv, POINTS) for n, l in msda_cases.items()}
    gouts = {n: torch.randn(b, l.shape[1], HEADS * HEAD_DIM, generator=g) for n, l in msda_cases.items()}
    qkvo32 = [torch.randn(TRAIN_BATCH, 3, 4096, 64, generator=g) for _ in range(4)]
    scale = 64**-0.5

    results = {}

    def record(name, dname, errors, kernel, plain):
        rec = dict(phase="kernel_bwd", name=name, dtype=dname,
                   max_abs_err=max(e[0] for e in errors.values()),
                   abs_err={n: e[0] for n, e in errors.items()},
                   rel_err={n: e[1] for n, e in errors.items()}, bound=GRAD_BOUNDS[dname],
                   ms=cuda_ms(kernel), plain_ms=cuda_ms(plain))
        log(**rec)
        for n, (_, rel) in errors.items():
            if not rel <= GRAD_BOUNDS[dname]:
                fail(f"{name} {dname}: {n}: max |kernel - autograd of plain| / max |plain| {rel} "
                     f"> {GRAD_BOUNDS[dname]}")
        results[(name, dname)] = rec

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        value = value32.to(dev, dtype)
        for name, loc in msda_cases.items():
            att, gout = atts[name].to(dev, dtype), gouts[name].to(dev, dtype)
            got = msda_bwd_cuda(value, TRAIN_SHAPES, loc, att, gout)
            leaves = [value.detach().float().requires_grad_(), loc.detach().clone().requires_grad_(),
                      att.detach().float().requires_grad_()]
            want = torch.autograd.grad(ms_deform_attn(leaves[0], TRAIN_SHAPES, *leaves[1:]),
                                       leaves, gout.float())
            err = _errors(("d_value", "d_loc", "d_att"), got, want)
            del got, leaves, want
            plain_leaves = [t.detach().clone().requires_grad_() for t in (value, loc, att)]
            out = ms_deform_attn(plain_leaves[0], TRAIN_SHAPES, *plain_leaves[1:])
            record(name, dname, err,
                   lambda: msda_bwd_cuda(value, TRAIN_SHAPES, loc, att, gout),
                   lambda: torch.autograd.grad(out, plain_leaves, gout, retain_graph=True))
            del out, plain_leaves
            torch.cuda.empty_cache()

        q, k, v, go = (t.to(dev, dtype) for t in qkvo32)
        out, lse = attn_fwd_cuda(q, k, v, scale, with_lse=True)
        delta = attn_bwd_delta_cuda(out, go)
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(global_attention_plain(*leaves, scale), leaves, go.float())
        plain_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        plain_out = global_attention_plain(*plain_leaves, scale)

        def plain_bwd(*which):  # autograd of the plain version for these of (q, k, v)
            return lambda: torch.autograd.grad(plain_out, [plain_leaves[i] for i in which], go,
                                               retain_graph=True)

        def kernel_bwd():  # the attention backward's three launches, as the train path runs them
            d = attn_bwd_delta_cuda(out, go)
            return (attn_bwd_dq_cuda(q, k, v, go, lse, d, scale),
                    *attn_bwd_dkv_cuda(q, k, v, go, lse, d, scale))

        record("attn_bwd_delta", dname,
               _errors(("delta",), [delta], [(out.float() * go.float()).sum(-1)]),
               lambda: attn_bwd_delta_cuda(out, go), lambda: (out.float() * go.float()).sum(-1))
        record("attn_bwd_dkv", dname,
               _errors(("dk", "dv"), attn_bwd_dkv_cuda(q, k, v, go, lse, delta, scale), want[1:]),
               lambda: attn_bwd_dkv_cuda(q, k, v, go, lse, delta, scale), plain_bwd(1, 2))
        record("attn_bwd_dq", dname,
               _errors(("dq",), [attn_bwd_dq_cuda(q, k, v, go, lse, delta, scale)], want[:1]),
               lambda: attn_bwd_dq_cuda(q, k, v, go, lse, delta, scale), plain_bwd(0))
        record("attn_bwd", dname, _errors(("dq", "dk", "dv"), kernel_bwd(), want),
               kernel_bwd, plain_bwd(0, 1, 2))
        del out, lse, delta, leaves, want, plain_leaves, plain_out
        torch.cuda.empty_cache()
    return results


def init_weights(model, seed: int, fan_in: bool = False):
    """Seeded weights, then every sampling_offsets bias re-armed with the ring
    init (realistic offsets). Default: N(0, 0.02) for every parameter, the
    bench protocol. fan_in: weight matrices N(0, 1 / fan-in), norm scales 1,
    the rest N(0, 0.02), so activations and first-stage scores spread out."""
    import torch

    from ape_tpu_torch.layers.msda_module import MultiScaleDeformableAttention, _offset_bias_init

    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in model.modules()
             if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm))}
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.02
            if fan_in and id(p) in norms:
                p.fill_(1.0)
                continue
            if fan_in and p.dim() >= 2 and not name.endswith("pos_embed"):
                std = p[0].numel() ** -0.5
            p.copy_(std * torch.randn(p.shape, generator=g))
        for m in model.modules():
            if isinstance(m, MultiScaleDeformableAttention):
                m.sampling_offsets.bias.copy_(torch.from_numpy(
                    _offset_bias_init(m.num_heads, m.num_levels, m.num_points)))
    return model


def _inputs():
    import torch

    g = torch.Generator().manual_seed(SEED + 1)
    return (torch.randn(1, IMG, IMG, 3, generator=g), torch.tensor([[IMG, IMG]]),
            torch.randn(1, NUM_TEXT, 1024, generator=g), torch.ones(1, NUM_TEXT, dtype=torch.bool))


def slice_phase(dev, card):
    """The protocol forward in bf16: launches, host syncs, outputs, images/s."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti
    from ape_tpu_torch.ops import _build

    model = build_ape_ti(num_queries=QUERIES, mask_on=False, window_radius=RADIUS,
                         scale_factors=(2.0, 1.0, 0.5), dtype=torch.bfloat16)
    model = init_weights(model, SEED).eval().to(dev)
    inputs = tuple(t.to(dev) for t in _inputs())
    with torch.no_grad():
        model(*inputs)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = model(*inputs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        if launches != dict(dict.fromkeys(launches, 0), msda_fwd=12, attn_fwd=4):
            fail(f"launches per forward {launches}, expected 12 MSDA and 4 attention")
        logits, boxes = out["pred_logits"], out["pred_boxes"]
        if tuple(logits.shape) != (1, QUERIES, NUM_TEXT) or tuple(boxes.shape) != (1, QUERIES, 4):
            fail(f"output shapes {tuple(logits.shape)} {tuple(boxes.shape)}")
        if not (torch.isfinite(logits).all() and torch.isfinite(boxes).all()):
            fail("non-finite outputs")
        syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)

        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            model(*inputs)
        torch.cuda.synchronize()
        img_s = iters / (time.perf_counter() - t0)
    log(phase="slice", dtype="bfloat16", launches_per_forward=launches,
        host_syncs_per_forward=syncs, logits_shape=list(logits.shape),
        boxes_shape=list(boxes.shape), images_per_s=img_s, iters=iters, card=card)
    return model


def f32_phase(model):
    """The same forward in f32, CUDA kernels against the plain versions (CPU
    tensors take them), with fan-in weights: under the bench's N(0, 0.02)
    weights the first-stage scores are spread so thinly that float order
    alone reorders near-ties, which would test the weights, not the kernels."""
    import torch

    init_weights(model, SEED, fan_in=True)
    model.dtype = torch.float32
    cpu_model = copy.deepcopy(model).cpu()
    inputs = _inputs()
    dev = next(model.parameters()).device
    with torch.no_grad():
        t0 = time.perf_counter()
        gpu = model(*(t.to(dev) for t in inputs))
        cpu = cpu_model(*inputs)
    mem_err = float((gpu["memory"].cpu() - cpu["memory"]).abs().max())
    sel_gpu, sel_cpu = gpu["first_stage_indices"].cpu(), cpu["first_stage_indices"]
    same_sel = bool(torch.equal(sel_gpu, sel_cpu))
    log(phase="slice_f32_vs_plain", memory_max_abs_err=mem_err, memory_bound=MEMORY_BOUND,
        memory_max_abs=float(cpu["memory"].abs().max()),
        first_stage_indices_identical=same_sel,
        first_stage_positions_differing=int((sel_gpu != sel_cpu).sum()),
        pred_boxes_max_abs_err=float((gpu["pred_boxes"].cpu() - cpu["pred_boxes"]).abs().max()),
        pred_logits_max_abs_err=float((gpu["pred_logits"].cpu() - cpu["pred_logits"]).abs().max()),
        seconds=time.perf_counter() - t0)
    if not mem_err <= MEMORY_BOUND:
        fail(f"f32 encoder memory differs by {mem_err} > {MEMORY_BOUND}")
    if not same_sel:
        fail("f32 first-stage indices differ between the CUDA kernels and the plain versions")


def _train_batch(dev, batch: int, img: int, seed: int):
    """Seeded inputs and detection targets as tools/bench_train.py draws them:
    80 texts of width 1024; 8 target slots per image, 4 valid, labels in
    [0, 80), cxcywh boxes uniform in [0.2, 0.6)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    slots = 8
    out = {
        "images": torch.randn(batch, img, img, 3, generator=g),
        "image_sizes": torch.tensor([[img, img]] * batch),
        "text_features": torch.randn(batch, NUM_TEXT, 1024, generator=g),
        "text_valid": torch.ones(batch, NUM_TEXT, dtype=torch.bool),
        "targets": {
            "labels": torch.randint(0, NUM_TEXT, (batch, slots), generator=g),
            "boxes": 0.2 + 0.4 * torch.rand(batch, slots, 4, generator=g),
            "valid": (torch.arange(slots) < 4)[None].repeat(batch, 1),
        },
    }
    return {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
            for k, v in out.items()}


def _criterion(queries: int):
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict

    return DeformableCriterion(num_classes=NUM_TEXT, weight_dict=default_weight_dict(),
                               num_queries=queries)


def train_phase(dev, card):
    """APE-Ti training at 1024^2, batch 2, bf16, with recompute checkpointing:
    finite losses and gradients, launches per step, s/step, peak memory."""
    import torch

    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.modeling.build import build_ape_ti
    from ape_tpu_torch.ops import _build

    model = build_ape_ti(num_queries=TRAIN_QUERIES, window_radius=RADIUS, mask_on=False,
                         use_act_checkpoint=True, dtype=torch.bfloat16)
    model = init_weights(model, SEED).to(dev)
    optimizer, scheduler = build_optimizer(model)
    step = make_train_step(model, _criterion(TRAIN_QUERIES), optimizer, scheduler)
    batch = _train_batch(dev, TRAIN_BATCH, TRAIN_IMG, SEED + 4)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    metrics = step(batch, gen)  # warm-up
    torch.cuda.synchronize()
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
    no_grad = [n for n, p in model.named_parameters()
               if p.requires_grad and (p.grad is None or not bool(torch.isfinite(p.grad).all()))]
    if bad or no_grad:
        fail(f"warm-up step: non-finite {bad}; missing or non-finite gradients {no_grad[:10]}")

    torch.cuda.reset_peak_memory_stats(dev)
    want = {k: TRAIN_STEPS * STEP_LAUNCHES.get(k, 0) for k in _build.LAUNCHES}
    _build.reset_launches()
    seconds = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
        if bad:
            fail(f"non-finite train metrics {bad}")
    launches = dict(_build.LAUNCHES)
    if launches != want:
        fail(f"launches over {TRAIN_STEPS} train steps {launches}, expected {want}")
    s_step = sum(seconds) / len(seconds)
    log(phase="train", dtype="bfloat16", image=TRAIN_IMG, batch=TRAIN_BATCH, queries=TRAIN_QUERIES,
        tokens=sum(h * w for h, w in TRAIN_SHAPES), steps=TRAIN_STEPS, seconds_per_step=seconds,
        s_per_step=s_step, images_per_s=TRAIN_BATCH / s_step,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        launches_per_step={k: v // TRAIN_STEPS for k, v in launches.items()},
        losses={k: float(v) for k, v in metrics.items()}, card=card)
    return launches


def grad_rel_errors(got, want):
    """Per parameter: max |got - want| over max |want|."""
    return {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for n, w in want.items()}


def f32_grad_bound(name: str) -> float:
    return F32_OFFSET_GRAD_RTOL if "sampling_offsets" in name else F32_GRAD_RTOL


def perturbed(batch, seed: int):
    """The batch with its images scaled by 1 + PERTURB * N(0, 1) (seeded)."""
    import torch

    images = batch["images"]
    noise = torch.randn(images.shape, generator=torch.Generator().manual_seed(seed))
    return dict(batch, images=images * (1 + PERTURB * noise.to(images.device)))


def step_grads(model, crit, batch, seed: int):
    """One f32 loss and backward: (total, first-stage indices, {name: gradient
    on the CPU})."""
    import torch

    from ape_tpu_torch.engine.train_step import loss_fn

    model.zero_grad(set_to_none=True)
    total, _, outputs = loss_fn(model, crit, batch, torch.Generator().manual_seed(seed))
    total.backward()
    return (total.item(), outputs["first_stage_indices"].cpu(),
            {n: p.grad.cpu() for n, p in model.named_parameters()})


def train_f32_phase(dev):
    """One f32 step (512^2, batch 1, protocol pyramid, fan-in weights) with the
    CUDA kernels, every parameter's gradient held against the plain versions
    on the CPU within its bound; the first-stage indices must match. Then the
    plain version against itself on perturbed images: the gradients' floor."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti

    model = build_ape_ti(num_queries=TRAIN_QUERIES, window_radius=RADIUS, mask_on=False,
                         scale_factors=(2.0, 1.0, 0.5), use_act_checkpoint=True)
    model = init_weights(model, SEED, fan_in=True).train()
    cpu_model = copy.deepcopy(model)
    model.to(dev)
    crit = _criterion(TRAIN_QUERIES)
    batch = _train_batch("cpu", 1, F32_TRAIN_IMG, SEED + 5)
    t0 = time.perf_counter()
    gpu_total, gpu_sel, gpu_grads = step_grads(
        model, crit, {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                          else v.to(dev)) for k, v in batch.items()}, SEED)
    cpu_total, cpu_sel, cpu_grads = step_grads(cpu_model, crit, batch, SEED)
    _, floor_sel, floor_grads = step_grads(cpu_model, crit, perturbed(batch, SEED + 6), SEED)
    rel = grad_rel_errors(gpu_grads, cpu_grads)
    floor = grad_rel_errors(floor_grads, cpu_grads)
    over = sorted(((n, r, f32_grad_bound(n)) for n, r in rel.items() if not r <= f32_grad_bound(n)),
                  key=lambda t: -t[1] / t[2])

    def worst(errs, offsets):
        return sorted(((n, r) for n, r in errs.items() if ("sampling_offsets" in n) == offsets),
                      key=lambda kv: -kv[1])[:3]

    same_sel = bool(torch.equal(gpu_sel, cpu_sel))
    log(phase="train_f32_vs_plain", image=F32_TRAIN_IMG, total_loss_cuda=gpu_total,
        total_loss_cpu=cpu_total, first_stage_indices_identical=same_sel, params=len(rel),
        worst_grad_rel_err=worst(rel, False), bound=F32_GRAD_RTOL,
        worst_offset_grad_rel_err=worst(rel, True), offset_bound=F32_OFFSET_GRAD_RTOL,
        perturbation=PERTURB, floor_first_stage_indices_identical=bool(torch.equal(floor_sel, cpu_sel)),
        floor_worst_grad_rel_err=worst(floor, False), floor_worst_offset_grad_rel_err=worst(floor, True),
        seconds=time.perf_counter() - t0)
    if not same_sel:
        fail("f32 train step: first-stage indices differ between the CUDA kernels and the plain versions")
    if over:
        fail(f"f32 train step: {len(over)} gradients over their bound, worst (name, rel, bound) {over[:3]}")


class StubLanguage:
    """Stands in for the text tower: a seeded feature per text (width 1024)."""

    def forward_text(self, text_list, cache=False):
        import numpy as np

        return np.stack([np.random.RandomState(zlib.crc32(t.encode())).randn(1024)
                         for t in text_list]).astype(np.float32)


def serve_phase(model):
    import numpy as np
    import torch

    from ape_tpu_torch.engine import APE, DefaultPredictor
    from ape_tpu_torch.ops import _build

    predictor = DefaultPredictor(APE(model, StubLanguage()), image_size=IMG)
    rng = np.random.RandomState(SEED + 2)
    requests = [((480, 640), "person, car, dog, umbrella"),
                ((800, 600), "a person riding a bike"),
                ((600, 800), "cat, bus, umbrella")]
    _build.reset_launches()
    counts = []
    for (h, w), prompt in requests:
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        res = predictor(image, prompt)
        torch.cuda.synchronize()
        inst = res["instances"]
        n = int(inst["scores"].numel())
        boxes = inst["boxes"]
        if not bool(torch.isfinite(boxes).all()) or (n and (boxes[:, 2:] > boxes.new_tensor([w, h]) + 1.0).any()):
            fail(f"request {h}x{w}: boxes not finite or outside the image")
        if n and int(inst["classes"].max()) >= len(res["text_list"]):
            fail(f"request {h}x{w}: class index outside the prompt")
        counts.append(n)
        log(phase="serve", image=[h, w], prompt=prompt, prompt_type=res["prompt_type"],
            instances=n, seconds=time.perf_counter() - t0)
    launches = dict(_build.LAUNCHES)
    want = dict(dict.fromkeys(launches, 0), msda_fwd=12 * len(requests),
                attn_fwd=4 * len(requests))
    if launches != want:
        fail(f"serve launches {launches}, expected {want}")
    return launches


def main():
    import torch

    if not (ROOT / "ape_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no ape_tpu_torch/: run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    kind, card = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    kern = kernels_phase(dev)
    kern.update(backward_kernels_phase(dev))
    model = slice_phase(dev, card)
    serve_phase(model)
    f32_phase(model)
    del model
    torch.cuda.empty_cache()
    launches = train_phase(dev, card)
    train_f32_phase(dev)
    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    sources = {"msda_fwd": ("msda_fwd.cu", "ape_tpu/ops/msda_window_pallas_v2.py:795", "msda_encoder"),
               "msda_bwd": ("msda_bwd.cu", "ape_tpu/ops/msda_window_pallas_bwd.py:961",
                            "msda_bwd_encoder"),
               "attn_fwd": ("attn_fwd.cu", "ape_tpu/modeling/backbone/eva_vit.py:136", "attention"),
               "attn_bwd_delta": ("attn_bwd.cu", f"{flash}:273", "attn_bwd_delta"),
               "attn_bwd_dkv": ("attn_bwd.cu", f"{flash}:941", "attn_bwd_dkv"),
               "attn_bwd_dq": ("attn_bwd.cu", f"{flash}:1287", "attn_bwd_dq")}
    kernels = []
    for name, (source, replaces, case) in sources.items():
        source = f"ape_tpu_torch/csrc/{source}"
        rec = kern[(case, "bfloat16")]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
