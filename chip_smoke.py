#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ape_tpu_torch``) of APE-Ti protocol inference
once on one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi's own line too);
2. build: compile ``ape_tpu_torch/csrc/*.cu`` into ``build/ape_tpu_torch/``;
3. kernels: each CUDA kernel against its plain PyTorch version at the shapes
   the main path gives it, in f32 (TF32 off) and bf16, with times;
4. slice: ``build_ape_ti`` at the reference latency protocol (1024^2, bf16,
   900 queries, 80 text features of width 1024, N(0, 0.02) weights with the
   ring-init offsets re-armed): launch counts per forward, host syncs,
   output checks, images/s;
5. serve: ``DefaultPredictor`` answers three non-square requests;
6. f32: the same forward in f32 held against the plain versions on the CPU.

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
MEMORY_BOUND = 1e-3  # f32 encoder memory, CUDA kernels vs plain on the CPU
SEED = 0


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
        if launches != {"msda_fwd": 12, "attn_fwd": 4}:
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
    want = {"msda_fwd": 12 * len(requests), "attn_fwd": 4 * len(requests)}
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
    model = slice_phase(dev, card)
    launches = serve_phase(model)
    f32_phase(model)
    sources = {"msda_fwd": ("ape_tpu_torch/csrc/msda_fwd.cu", "ape_tpu/ops/msda_window_pallas_v2.py:795",
                            "msda_encoder"),
               "attn_fwd": ("ape_tpu_torch/csrc/attn_fwd.cu", "ape_tpu/modeling/backbone/eva_vit.py:136",
                            "attention")}
    kernels = []
    for name, (source, replaces, case) in sources.items():
        rec = kern[(case, "bfloat16")]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
