#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ape_tpu_torch``) of APE-Ti on one NVIDIA
card, from the root of a checkout: protocol inference, detection training,
then the full masked model's inference and training.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi's own line too);
2. build: compile ``ape_tpu_torch/csrc/*.cu`` into ``build/ape_tpu_torch/``;
   then the SASS: every bf16 instance of the attention forward, dQ and dK/dV
   kernels holds tensor-core products (HMMA), no f32 one does, and none
   spills at head width 64; every instance of the merged MSDA backward's
   D = 32 body holds 16-byte vector reductions into d_value, no scalar one,
   and spills nothing; every instance of K1's D = 32 body reads its corners
   by 64-bit (bf16) or 128-bit (f32) loads, no 16-bit one, and spills
   nothing; every instance of K8's D = 32 body loads its boxes by TMA
   (UTMALDG) and reads them by 64-bit (bf16) or 128-bit (f32) shared loads,
   no 16-bit value load, within 64 registers and no spill; every instance of
   K3's D = 32 body reads its corners by 64- or 128-bit loads, holds no
   reduction or atomic, and spills nothing; every instance of K4's D = 32
   body holds only 16-byte vector reductions, within 64 registers and no
   spill; every instance of K9's D = 32 body holds tensor-core products
   (HMMA) and TMA loads (UTMALDG) and spills nothing; the general bodies'
   instances are recorded beside;
3. kernels: each forward CUDA kernel against its plain PyTorch version at
   every shape set the main paths give it (the protocol pyramid at batch 1;
   the 4-scale pyramid at batch 1 with 900 decoder queries and at batch 2
   with 300), in f32 (TF32 off) and bf16, with times, and attention's beside
   ``F.scaled_dot_product_attention``; K1's D = 32 body against its general
   body bit for bit, and its window entry (the clip inside) against K1 on
   ``window_locations`` bit for bit, each timed, the window entry also
   against the ``window_locations`` + K1 it replaces; then the encoder's
   other window forms, K6 (all pairs), K7 (+ K6), K8 and K9 (+ K1), each
   against the plain version and against K1 at the protocol pyramid (batch
   1) and the 4-scale one (batch 2); K8's D = 32 body also against K1's
   window entry and K1 on ``window_locations`` bit for bit, as planned and
   with a budget cut to force groups, and its general body timed beside;
   K9's D = 32 body (bf16) also in out mode "store" against the f32 plain
   version within 2e-4, its general body timed beside;
4. backward kernels: each backward kernel against torch autograd of its
   plain version at the training shapes, in f32 and bf16, with times (the
   attention backward beside that of ``F.scaled_dot_product_attention``,
   both also as their kernels' device time by ``torch.profiler``; the dQ
   kernel's delta also against the plain row sum of O * dO); the split
   MSDA backward (K3, K4) also against the merged one (K2), K3's D = 32
   body's d_loc and d_att bit for bit, K4's D = 32 body's d_value within
   the split bound, their general bodies within bounds and timed beside;
   K2 at head width 32 (the encoder's and the decoder's case) and, for its
   general body, 64 (the decoder's);
5. slice: ``build_ape_ti`` at the reference latency protocol (1024^2, bf16,
   900 queries, 80 text features of width 1024, N(0, 0.02) weights with the
   ring-init offsets re-armed): launch counts per forward, host syncs (each
   one the NMS fixpoint's loop test), output checks, images/s;
6. serve: ``DefaultPredictor`` answers three non-square requests;
   forms: the same forward under ``msda_dispatch.FUSED`` (K8) and under
   ``V6`` (K9 + K1): exact launches, outputs, images/s;
7. f32: the same forward in f32 held against the plain versions on the CPU,
   its encoder memory also under each form;
8. train: APE-Ti training as ``tools/bench_train.py`` runs it without masks
   (1024^2, batch 2, 300 queries, default pyramid, bf16 over f32 params,
   recompute checkpointing, 80 texts, 8 target slots with 4 valid), through
   ``build_optimizer`` and ``make_train_step``: one warm-up step, three timed
   steps; finite losses and gradients, launches per step, s/step, memory;
   then a warm-up and one step under ``FUSED`` (K8 forward and recompute,
   K2 backward);
9. train f32: one f32 step at 512^2, batch 1, protocol pyramid, fan-in
   weights: every parameter's gradient held against the plain versions on
   the CPU, and the plain gradients' own floor under a perturbation of the
   images at f32 rounding size;
10. full serve: ``build_ape_ti()`` with its defaults, the masked model on the
    4-scale pyramid (1024^2, bf16, 900 queries, S = 87,296 tokens): launches
    per forward, finite ``pred_masks`` (1, 900, 256, 256), images/s, and
    three ``DefaultPredictor`` requests with ``mask_logits`` and ``sem_seg``;
    then a forward under ``V6``, whose two 128-wide query levels take K9;
11. full train: the masked model as ``tools/bench_train.py`` trains it (as 8,
    with ``masks`` (2, 8, 256, 256) drawn as rand > 0.7 and losses class,
    boxes and masks): one warm-up and three timed steps with the merged MSDA
    backward (K2), then as many with the split one (K3 + K4,
    ``msda_dispatch.BWD_MERGED = False``); exact launches of each form;
12. full train f32: phase 9 for the masked model on the default pyramid,
    then the same step once more with the split backward, held against the
    merged one;
13. race: ``ape_tpu_torch.tools.msda_race``, every window-MSDA forward
    form at both pyramids and both offset draws, its per-pair suites, and
    K8's D = 32 body by its parts (device time per query level);
    then ``ape_tpu_torch.tools.msda_bwd_race``, the backward forms (K2, K3 +
    K4, autograd of the plain version) at the same pyramids and draws, each
    within its bound of the plain version or of K2;
14. probes: ``ape_tpu_torch.tools.pair_probe`` (K10, every variant on the
    four pairs, bf16 value, each within 1e-5 of its plain version, bf16fma
    within 6.4e-2 of base, base against K1 bit for bit) and
    ``ape_tpu_torch.tools.backbone_fix_probe`` (K11, every tile beside K5,
    the einsum forms and ``scaled_dot_product_attention``, each tile and K5
    against the plain attention in bf16 within four bf16 steps of its largest
    output and in f32 within 1e-4, (64, 64) against K5 bit for bit; and the
    patchify as a convolution and as a matmul).

Then the kernels line (each kernel's launches over every path: ``launches``
over all of them, ``launches_main`` over the serving and training phases
alone, 5-11, ``launches_default`` over those of them that run the default
flags: slice, serve, train, full serve and full train with the merged
backward; error, time, plain and library time, and bound; for K1, K3, K4,
K8 and K9, whose D = 32 body runs there, the general body's time as
``general_ms``) and, last,
{"ok": true, "device": {...}}. The script needs the repository around it and
a CUDA card; it imports no JAX.
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
# The kernels' bounds (the forward ones against the plain version, the
# backward ones against autograd of it, and the split MSDA backward against
# the merged one) are ops/bounds.py's.
MEMORY_BOUND = 1e-3  # f32 encoder memory, CUDA kernels vs plain on the CPU
SEED = 0

TRAIN_IMG, TRAIN_BATCH, TRAIN_QUERIES, TRAIN_STEPS = 1024, 2, 300, 3
TRAIN_SHAPES = ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16))  # default pyramid at 1024^2
# Launches per train step with every encoder and decoder layer recomputed in
# the backward: 6 + 6 MSDA forwards, again in the recompute, one backward
# each; the backbone (not recomputed) runs 4 global blocks once each way.
STEP_LAUNCHES = {"msda_fwd": 24, "msda_bwd": 12, "attn_fwd": 4, "attn_bwd_dkv": 4,
                 "attn_bwd_dq": 4}
# With the split form the encoder's 6 MSDA backwards run K3 + K4 and the
# decoder's 6 stay on K2. The mask head launches no MSDA or attention kernel.
SPLIT_STEP_LAUNCHES = dict(STEP_LAUNCHES, msda_bwd=6, msda_bwd_offatt=6, msda_bwd_value=6)
# Per forward of either model: 4 global attention blocks, 6 + 6 MSDA
# layers: the encoder's on K1's window entry (no gradient: the clip runs in
# the kernel), the decoder's on K1.
FORWARD_LAUNCHES = {"msda_fwd": 6, "msda_fwd_window": 6, "attn_fwd": 4}
ENCODER_LAYERS = 6
# The encoder's other forward forms, by the flag of msda_dispatch that
# selects them: K8 under FUSED, K9 (+ K1 on the narrow query levels) under V6.
FORM_FLAGS = {"qlevel": "FUSED", "dense": "V6"}
WINDOW_FORMS = ("pair", "rows", "qlevel", "dense")
FORM_ITERS = 10  # timed calls per form (kernels phase) and per race measurement
# Peaks of an H100 SXM at 700 W: HBM bytes/s; dense bf16 tensor-core
# FLOP/s for the attention products; f32 FLOP/s outside the tensor cores
# for MSDA's per-sample arithmetic and f32 attention.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# f32 flops per (sample, channel): forward 4 corner FMAs and the weight's;
# K2 adds the three dot products (d_att, d_x, d_y) and the 4 scatters.
MSDA_SAMPLE_FLOPS = {"msda_fwd": 10, "msda_fwd_window": 10, "msda_bwd": 26,
                     "msda_bwd_offatt": 22, "msda_bwd_value": 4}
MASK_SIDE = IMG // 4  # mask features and GT masks of the full model at 1024^2
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
# f32 masked step, split backward against merged, per parameter as above. The
# forward is the same launch for launch, and both backward forms run the same
# per-sample arithmetic (csrc/msda_sample.cuh): they differ by the order of
# the f32 atomic adds into d_value (a few 1e-6 relative, phase 4), carried
# back through the backbone.
F32_SPLIT_RTOL = 1e-3


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


PROFILE_TRIES = 3


def kernel_ms(fn, iters: int = 20) -> float:
    """Summed device time of the kernels fn() launches, per call, by
    torch.profiler over ``iters`` calls after one warm-up: unlike
    ``cuda_ms``, it leaves out the device's idle time between launches,
    where the host is still in Python or autograd. A profiled window at
    times comes back with no device activity at all (once in the K1 body
    sweep of one run on an H100): it is profiled again, at most
    PROFILE_TRIES times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)
        if us > 0:
            return us / 1e3 / iters
    fail(f"torch.profiler recorded no device time in {PROFILE_TRIES} windows")


def bound(nbytes: float, flops: float, peak: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over their peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def msda_bound(kernel: str, b: int, s: int, q: int, l: int, esize: int, d: int = HEAD_DIM):
    """Bound of an MSDA kernel with HEADS x d channels, S value tokens, Q
    queries, L levels: each input read once and each output written once
    (locations, offsets and d_loc f32, the rest in the value's dtype; K1's
    window entry also reads Q grid centers, (x, y) in f32, and 2 flops an
    offset's coordinate, the divide and the add)."""
    value, rows = b * s * HEADS * d * esize, b * q * HEADS * d * esize
    samples = b * q * HEADS * l * POINTS
    loc, att = samples * 8, samples * esize
    if kernel == "msda_fwd_window":
        nbytes = value + loc + att + rows + q * 8
        return bound(nbytes, samples * (d * MSDA_SAMPLE_FLOPS[kernel] + 4), PEAK_FLOPS["float32"])
    nbytes = {"msda_fwd": value + loc + att + rows,
              "msda_bwd": 2 * (value + loc + att) + rows,
              "msda_bwd_offatt": value + 2 * (loc + att) + rows,
              "msda_bwd_value": loc + att + rows + value}[kernel]
    return bound(nbytes, samples * d * MSDA_SAMPLE_FLOPS[kernel], PEAK_FLOPS["float32"])


def attn_bound(kernel: str, shape, dname: str):
    """Bound of an attention kernel on (B, heads, N, Dh) tensors: inputs
    read once, outputs written once (dQ: q, k, v, O, dO and lse in, dQ and
    delta out; dK/dV: q, k, v, dO, lse and delta in); 4 N^2 Dh flops a head
    forward, 8 for dK and dV, 6 for dQ."""
    b, h, n, dh = shape
    t, f32 = b * h * n * dh * (2 if dname == "bfloat16" else 4), b * h * n * 4
    nbytes, mults = {"attn_fwd": (4 * t, 4), "attn_bwd_dkv": (6 * t + 2 * f32, 8),
                     "attn_bwd_dq": (6 * t + 2 * f32, 6), "attn_bwd": (8 * t + f32, 14)}[kernel]
    return bound(nbytes, mults * b * h * n * n * dh, PEAK_FLOPS[dname])


def with_form(base: dict, form: str, shapes, esize: int, passes: int = 1) -> dict:
    """``base`` launches with the encoder's K1 forwards (ENCODER_LAYERS per
    pass: on K1's window entry where ``base`` counts one, else on K1) taken
    by a form's launches (ops/msda_window_forms.plan_layer)."""
    from ape_tpu_torch.ops.msda_window_forms import launches_per_layer, plan_layer

    key = "msda_fwd_window" if "msda_fwd_window" in base else "msda_fwd"
    out = dict(base, **{key: base[key] - passes * ENCODER_LAYERS})
    if not out[key]:
        del out[key]
    for k, v in launches_per_layer(plan_layer(form, shapes, HEAD_DIM, esize, RADIUS)).items():
        out[k] = out.get(k, 0) + passes * ENCODER_LAYERS * v
    return out


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
    tensor_core_check()
    vector_reduction_check()
    vector_gather_check()
    d32_body_check(QLEVEL_D32_KERNEL, GENERAL_K8_KERNEL, qlevel_faults, D32_INSTANCES)
    d32_body_check(OFFATT_D32_KERNEL, GENERAL_K3_KERNEL, offatt_faults, D32_INSTANCES)
    d32_body_check(VALUE_D32_KERNEL, GENERAL_K4_KERNEL, value_faults, D32_INSTANCES)
    d32_body_check(DENSE_D32_KERNEL, GENERAL_K9_KERNEL, dense_faults, DENSE_D32_INSTANCES)


# Kernels whose bf16 instances run on the tensor cores (mma.sync, HMMA in their
# SASS) and whose f32 instances must not (there they would compute in TF32).
TENSOR_CORE_KERNELS = ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")


def tensor_core_check():
    """Every instance of TENSOR_CORE_KERNELS in the built library: HMMA in
    each bf16 one and in no f32 one, and no spills at head width 64 (the
    main path's). One record an instance: its static SASS counts and what
    ptxas reported."""
    import re

    from ape_tpu_torch.ops import _build

    info = _build.ptxas_info()
    recs, bad = [], []
    for name, ops in sorted(_build.sass_counts("attn_").items()):
        m = re.search(rf"({'|'.join(TENSOR_CORE_KERNELS)})ILi(\d+)E", name)
        if m is None:
            continue
        bf16 = "__nv_bfloat16" in name
        rec = dict(phase="sass", kernel=m.group(1), head_dim=int(m.group(2)),
                   dtype="bfloat16" if bf16 else "float32", name=name, **ops,
                   **info.get(name, {}))
        log(**rec)
        recs.append(rec)
        if bf16 != (ops["HMMA"] > 0):
            bad.append(f"{name}: {ops['HMMA']} HMMA in a {rec['dtype']} instance")
        if bf16 and rec["head_dim"] == 64 and rec.get("spill_stores", 0):
            bad.append(f"{name}: spills {rec['spill_stores']} bytes at head width 64")
    found = {(r["kernel"], r["dtype"]) for r in recs}
    missing = [(k, d) for k in TENSOR_CORE_KERNELS for d in ("bfloat16", "float32")
               if (k, d) not in found]
    if missing or bad:
        fail(f"tensor-core check: instances missing {missing}; {'; '.join(bad)}")


# The merged MSDA backward's D = 32 body (K2 on every main path): each corner's
# d_value update is one 16-byte vector reduction (REDG.E.ADD.F32x4).
VECTOR_REDUCTION_KERNEL = "msda_bwd_kernel_d32"
# K2's general body, for every other head width (mangled as
# msda_bwd_kernelI<types>): scalar reductions, recorded beside it
GENERAL_K2_KERNEL = "msda_bwd_kernelI"
# instances of each: (value, attention weights) bf16/bf16, bf16/f32, f32/f32
VECTOR_REDUCTION_INSTANCES = 3


def vector_reduction_check():
    """Every instance of VECTOR_REDUCTION_KERNEL in the built library: vector
    reductions into d_value and no scalar one, and no spills; and every
    instance of K2's general body, present. One record an instance: its
    static SASS counts and what ptxas reported."""
    from ape_tpu_torch.ops import _build

    info = _build.ptxas_info()
    counts = _build.sass_counts(VECTOR_REDUCTION_KERNEL)
    general = _build.sass_counts(GENERAL_K2_KERNEL)
    bad = []
    for name, ops in sorted(counts.items()):
        rec = dict(phase="sass", kernel=VECTOR_REDUCTION_KERNEL, name=name, **ops,
                   **info.get(name, {}))
        log(**rec)
        if not 0 < ops["REDG_V4"] == ops["REDG"]:
            bad.append(f"{name}: {ops['REDG_V4']} vector reductions of {ops['REDG']}")
        if rec.get("spill_stores", 0):
            bad.append(f"{name}: spills {rec['spill_stores']} bytes")
    for name, ops in sorted(general.items()):
        log(phase="sass", kernel="msda_bwd_kernel", name=name, **ops, **info.get(name, {}))
    if (len(counts) != VECTOR_REDUCTION_INSTANCES or len(general) != VECTOR_REDUCTION_INSTANCES
            or bad):
        fail(f"vector-reduction check: {len(counts)} instances of {VECTOR_REDUCTION_KERNEL} and "
             f"{len(general)} of msda_bwd_kernel, expected {VECTOR_REDUCTION_INSTANCES} each; "
             f"{'; '.join(bad)}")


# K1's D = 32 body (every main path's MSDA forward): each corner read is one
# 64-bit load of 4 bf16 channels or one 128-bit load of 4 f32 ones.
VECTOR_GATHER_KERNEL = "msda_fwd_kernel_d32"
GENERAL_K1_KERNEL = "msda_fwd_kernelI"  # the general body, every head width
# instances of each: (value, attention weights) bf16/bf16, bf16/f32, f32/f32,
# each for the location entry and the window entry
VECTOR_GATHER_INSTANCES = 6


def _gather_instance(name: str):
    """(value dtype, attention-weight dtype, window entry) of an instance of
    K1's D = 32 body, from its mangled template arguments."""
    import re

    m = re.search(rf"{VECTOR_GATHER_KERNEL}I(.+?)Lb([01])E", name)
    if m is None:
        fail(f"unexpected instance {name}")
    args = m.group(1)
    value = "bfloat16" if args.startswith("13__nv_bfloat16") else "float32"
    return value, "float32" if args.endswith("f") else value, m.group(2) == "1"


def gather_faults(name: str, ops: dict, info: dict):
    """One instance of VECTOR_GATHER_KERNEL: (its record, its faults): fewer
    than four corner loads of the value dtype's 4-channel width (64 bits in
    bf16, 128 in f32; the location loads are 64-bit too), a 16-bit load
    besides a bf16 attention weight's one, a spill."""
    value, att, window = _gather_instance(name)
    width = 64 if value == "bfloat16" else 128
    rec = dict(phase="sass", kernel=VECTOR_GATHER_KERNEL, value=value, att=att, window=window,
               corner_load_bits=width, name=name, **ops, **info)
    bad = []
    if ops[f"LDG_{width}"] < 4:
        bad.append(f"{name}: {ops[f'LDG_{width}']} {width}-bit loads, fewer than 4 corners")
    if ops["LDG_16"] > (att == "bfloat16"):
        bad.append(f"{name}: {ops['LDG_16']} 16-bit loads")
    return rec, bad + _spill_faults(name, info)


def vector_gather_check():
    """Every instance of VECTOR_GATHER_KERNEL held to ``gather_faults``, the
    general body's instances recorded beside (``d32_body_check``)."""
    d32_body_check(VECTOR_GATHER_KERNEL, GENERAL_K1_KERNEL, gather_faults,
                   VECTOR_GATHER_INSTANCES)


def d32_body_check(kernel: str, general: str, faults, instances):
    """Every instance of a D = 32 body in the built library held to
    ``faults(name, ops, info) -> (record, faults)``, one record an instance
    (its static SASS counts and what ptxas reported), and each instance of
    the kernel's general body (mangled ``general``) recorded beside; each
    body must have ``instances`` instances (an int, or (D = 32 body,
    general body))."""
    from ape_tpu_torch.ops import _build

    info = _build.ptxas_info()
    counts = _build.sass_counts(kernel)
    others = _build.sass_counts(general)
    bad = []
    for name, ops in sorted(counts.items()):
        rec, found = faults(name, ops, info.get(name, {}))
        log(**rec)
        bad += found
    for name, ops in sorted(others.items()):
        log(phase="sass", kernel=general.rstrip("I"), name=name, **ops, **info.get(name, {}))
    want = instances if isinstance(instances, tuple) else (instances, instances)
    if (len(counts), len(others)) != want or bad:
        fail(f"SASS check of {kernel}: {len(counts)} instances and {len(others)} of "
             f"{general.rstrip('I')}, expected {want}; {'; '.join(bad)}")


# K8's, K3's and K4's D = 32 bodies, and their general ones (every head
# width), each with instances (value or grad, attention weights) bf16/bf16,
# bf16/f32, f32/f32; K9's D = 32 body takes a bf16 value only, with bf16 or
# f32 weights, its general body the three pairs.
QLEVEL_D32_KERNEL, GENERAL_K8_KERNEL = "msda_fwd_qlevel_kernel_d32", "msda_fwd_qlevel_kernelI"
OFFATT_D32_KERNEL, GENERAL_K3_KERNEL = "msda_bwd_offatt_kernel_d32", "msda_bwd_offatt_kernelI"
VALUE_D32_KERNEL, GENERAL_K4_KERNEL = "msda_bwd_value_kernel_d32", "msda_bwd_value_kernelI"
DENSE_D32_KERNEL, GENERAL_K9_KERNEL = "msda_fwd_dense_kernel_d32", "msda_fwd_dense_kernelI"
D32_INSTANCES = 3
DENSE_D32_INSTANCES = (2, 3)
D32_MAX_REGISTERS = 64  # __launch_bounds__(256, 4)


def _instance_dtypes(kernel: str, name: str):
    """(value dtype, attention-weight dtype) of an instance of a kernel
    templated on <value, weights>, from its mangled template arguments."""
    import re

    m = re.search(rf"{kernel}I(.+?)EEv", name)
    if m is None:
        fail(f"unexpected instance {name}")
    args = m.group(1)
    value = "bfloat16" if args.startswith("13__nv_bfloat16") else "float32"
    return value, "float32" if args.endswith("f") else value


def _dense_att(name: str):
    """The attention-weight dtype of an instance of K9's D = 32 body, its one
    template argument."""
    import re

    m = re.search(rf"{DENSE_D32_KERNEL}I(.+?)EEv", name)
    if m is None:
        fail(f"unexpected instance {name}")
    return "float32" if m.group(1) == "f" else "bfloat16"


def _spill_faults(name: str, info: dict):
    if info.get("spill_stores", 0) or info.get("spill_loads", 0):
        return [f"{name}: spills {info.get('spill_stores')} / {info.get('spill_loads')} bytes"]
    return []


def qlevel_faults(name: str, ops: dict, info: dict):
    """One instance of K8's D = 32 body: (its record, its faults): no TMA load
    (UTMALDG), fewer than four box corner reads of the value dtype's
    4-channel width from shared memory (LDS.64 in bf16, LDS.128 in f32), a
    16-bit load from shared memory or, besides a bf16 attention weight's,
    from device memory, over D32_MAX_REGISTERS registers, a spill."""
    value, att = _instance_dtypes(QLEVEL_D32_KERNEL, name)
    width = 64 if value == "bfloat16" else 128
    rec = dict(phase="sass", kernel=QLEVEL_D32_KERNEL, value=value, att=att,
               box_load_bits=width, name=name, **ops, **info)
    bad = _spill_faults(name, info)
    if ops["UTMALDG"] < 1:
        bad.append(f"{name}: no TMA load")
    if ops[f"LDS_{width}"] < 4:
        bad.append(f"{name}: {ops[f'LDS_{width}']} {width}-bit shared loads, fewer than 4 corners")
    if ops["LDS_16"] or ops["LDG_16"] > (att == "bfloat16"):
        bad.append(f"{name}: {ops['LDS_16']} 16-bit shared and {ops['LDG_16']} device loads")
    if info.get("registers", 0) > D32_MAX_REGISTERS:
        bad.append(f"{name}: {info['registers']} registers")
    return rec, bad


def offatt_faults(name: str, ops: dict, info: dict):
    """One instance of K3's D = 32 body: (its record, its faults): fewer than
    four corner loads of the value dtype's 4-channel width (LDG.E.64 in
    bf16, LDG.E.128 in f32), any reduction or atomic (it writes each output
    once), a spill."""
    value, att = _instance_dtypes(OFFATT_D32_KERNEL, name)
    width = 64 if value == "bfloat16" else 128
    rec = dict(phase="sass", kernel=OFFATT_D32_KERNEL, value=value, att=att,
               corner_load_bits=width, name=name, **ops, **info)
    bad = _spill_faults(name, info)
    if ops[f"LDG_{width}"] < 4:
        bad.append(f"{name}: {ops[f'LDG_{width}']} {width}-bit loads, fewer than 4 corners")
    if ops["REDG"] or ops["ATOMG"] or ops["ATOM"]:
        bad.append(f"{name}: {ops['REDG']} REDG, {ops['ATOMG']} ATOMG, {ops['ATOM']} ATOM")
    return rec, bad


def value_faults(name: str, ops: dict, info: dict):
    """One instance of K4's D = 32 body: (its record, its faults): a
    reduction into d_value that is not a 16-byte vector one, none at all,
    over D32_MAX_REGISTERS registers, a spill."""
    grad, att = _instance_dtypes(VALUE_D32_KERNEL, name)
    rec = dict(phase="sass", kernel=VALUE_D32_KERNEL, grad=grad, att=att, name=name, **ops,
               **info)
    bad = _spill_faults(name, info)
    if not 0 < ops["REDG_V4"] == ops["REDG"] or ops["ATOMG"] or ops["ATOM"]:
        bad.append(f"{name}: {ops['REDG_V4']} vector reductions of {ops['REDG']} REDG, "
                   f"{ops['ATOMG']} ATOMG, {ops['ATOM']} ATOM")
    if info.get("registers", 0) > D32_MAX_REGISTERS:
        bad.append(f"{name}: {info['registers']} registers")
    return rec, bad


def dense_faults(name: str, ops: dict, info: dict):
    """One instance of K9's D = 32 body: (its record, its faults): no
    tensor-core product (HMMA), no ldmatrix (LDSM), no TMA load (UTMALDG),
    a spill."""
    rec = dict(phase="sass", kernel=DENSE_D32_KERNEL, value="bfloat16", att=_dense_att(name),
               name=name, **ops, **info)
    bad = _spill_faults(name, info)
    if ops["HMMA"] < 1 or ops["LDSM"] < 1 or ops["UTMALDG"] < 1:
        bad.append(f"{name}: {ops['HMMA']} HMMA, {ops['LDSM']} LDSM, {ops['UTMALDG']} UTMALDG")
    return rec, bad


def _ring(levels: int):
    import torch

    from ape_tpu_torch.layers.msda_module import _offset_bias_init

    return torch.from_numpy(_offset_bias_init(HEADS, levels, POINTS)).view(HEADS, levels, POINTS, 2)


def _msda_inputs(g, shapes, batch: int, queries: int, dev):
    """Seeded MSDA inputs on a pyramid: (value (B, S, H, D) f32 on the CPU,
    {mode: f32 locations on dev}, {mode: attention weights (B, Q, H, L, P)
    f32 on the CPU}, the encoder's pixel offsets on dev) for the encoder's
    window mode (queries are the pyramid grid; ring-init offsets, radius
    p + 1 px, plus learned-scale noise, clipped to R) and the decoder's exact
    mode (``queries`` box references, loc = ref + off / P * wh * 0.5)."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import window_locations

    s, lv = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(batch, s, HEADS, HEAD_DIM, generator=g)
    off = (_ring(lv)[None, None] + 1.5 * torch.randn(batch, s, HEADS, lv, POINTS, 2, generator=g)
           ).to(dev)
    refs = torch.cat([0.1 + 0.8 * torch.rand(batch, queries, 1, 2, generator=g),
                      0.02 + 0.3 * torch.rand(batch, queries, 1, 2, generator=g)], -1)
    doff = _ring(lv)[None, None] + torch.randn(batch, queries, HEADS, lv, POINTS, 2, generator=g)
    locs = {"encoder": window_locations(shapes, off, RADIUS).contiguous(),
            "decoder": (refs[:, :, None, :, None, :2] + doff / POINTS
                        * refs[:, :, None, :, None, 2:] * 0.5).to(dev).contiguous()}
    atts = {m: torch.softmax(torch.randn(batch, l.shape[1], HEADS, lv * POINTS, generator=g), -1)
            .view(batch, l.shape[1], HEADS, lv, POINTS) for m, l in locs.items()}
    return value, locs, atts, off


# The forward kernels' cases, one per shape set a main path gives them:
# (suffix of the case names, pyramid, batch, decoder queries, attention
# checked). The protocol forward; the full serve forward (4-scale pyramid,
# S = 87,296; its attention is the protocol's); training (batch 2, 300
# queries). The kernels line reads the protocol's cases.
FWD_CASES = (("", SHAPES, 1, QUERIES, True),
             ("_full_serve", TRAIN_SHAPES, 1, QUERIES, False),
             ("_train", TRAIN_SHAPES, TRAIN_BATCH, TRAIN_QUERIES, True))


def k1_bodies(value, shapes, loc, att, name: str, dname: str) -> dict:
    """K1's two bodies on the same inputs: the D = 32 body against the
    general one bit for bit, each timed; the record's fields."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import BODIES, fwd_body, msda_fwd_cuda

    outs = {b: msda_fwd_cuda(value, shapes, loc, att, body=b) for b in BODIES}
    if not torch.equal(outs["d32"], outs["general"]):
        err = float((outs["d32"].float() - outs["general"].float()).abs().max())
        fail(f"{name} {dname}: K1's D = 32 body differs from its general body by {err}")
    b, q, h = loc.shape[:3]
    rec = dict(body=fwd_body(value.shape[-1]), items=b * q * h, d32_equals_general=True)
    for body in BODIES:  # by events, and by device time (a short launch follows the host)
        def fn(body=body):
            return msda_fwd_cuda(value, shapes, loc, att, body=body)

        rec.update({f"{body}_ms": cuda_ms(fn), f"{body}_device_ms": kernel_ms(fn)})
    return rec


# Item counts (B * Q * H) at which the kernels phase times K1's two bodies on
# the decoder's 4-scale batch-2 inputs, the decoder's own among them: the
# D = 32 body takes every launch at head width 32 (ops/msda_dispatch.fwd_body)
# while it is the faster at each, which the record's d32_slower_at lists.
BODY_SWEEP_ITEMS = (400, 800, 1600, 3200, 4800, 7200, 9600, 14400, 19200, 38400)


def k1_body_sweep(dev):
    """K1's two bodies timed by their device time (``kernel_ms``: at these
    sizes a launch takes about as long as the host's call) at
    BODY_SWEEP_ITEMS items in bf16, the first queries of the decoder's
    inputs (4-scale pyramid, batch 2); one record."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import BODIES, msda_fwd_cuda

    g = torch.Generator().manual_seed(SEED + 8)
    queries = max(BODY_SWEEP_ITEMS) // (TRAIN_BATCH * HEADS)
    value32, locs, atts, _ = _msda_inputs(g, TRAIN_SHAPES, TRAIN_BATCH, queries, dev)
    value = value32.to(dev, torch.bfloat16)
    times = {b: [] for b in BODIES}
    for items in BODY_SWEEP_ITEMS:
        q = items // (TRAIN_BATCH * HEADS)
        loc = locs["decoder"][:, :q].contiguous()
        att = atts["decoder"][:, :q].to(dev, torch.bfloat16).contiguous()
        for b in BODIES:
            times[b].append(kernel_ms(lambda: msda_fwd_cuda(value, TRAIN_SHAPES, loc, att,
                                                            body=b), 50))
    log(phase="kernel_k1_bodies", dtype="bfloat16", items=list(BODY_SWEEP_ITEMS),
        **{f"{b}_device_ms": t for b, t in times.items()},
        d32_slower_at=[n for n, d, gen in zip(BODY_SWEEP_ITEMS, times["d32"], times["general"])
                       if d > gen])


def k1_window(value, shapes, off, loc, att, name: str, dname: str) -> dict:
    """K1's window entry against K1 on ``window_locations`` (``loc``), bit
    for bit with each body, and timed against the ``window_locations`` + K1
    it replaces; the record's fields."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import (
        BODIES,
        msda_fwd_cuda,
        msda_fwd_window_cuda,
        window_locations,
    )

    for b in BODIES:
        got = msda_fwd_window_cuda(value, shapes, off, att, RADIUS, body=b)
        want = msda_fwd_cuda(value, shapes, loc, att, body=b)
        if not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            fail(f"{name} {dname}: K1's window entry ({b} body) differs from K1 on "
                 f"window_locations by {err}")
    return dict(equals_msda_fwd=True,
                locations_and_msda_fwd_ms=cuda_ms(lambda: msda_fwd_cuda(
                    value, shapes, window_locations(shapes, off, RADIUS).contiguous(), att)))


def kernels_phase(dev):
    """Each forward kernel against its plain version at every shape set of
    the main paths (FWD_CASES), in f32 and bf16, K1's two bodies and its
    window entry against each other (k1_bodies, k1_window), then the window
    forms (forms_kernels_step); returns per-case results."""
    import torch
    import torch.nn.functional as F

    from ape_tpu_torch.ops.attention import attn_fwd_cuda, global_attention_plain
    from ape_tpu_torch.ops.bounds import FWD_BOUNDS as BOUNDS
    from ape_tpu_torch.ops.msda import ms_deform_attn
    from ape_tpu_torch.ops.msda_dispatch import (
        msda_fwd_cuda,
        msda_fwd_window_cuda,
        window_locations,
    )

    g = torch.Generator().manual_seed(SEED)
    results = {}
    for suffix, shapes, batch, queries, with_attn in FWD_CASES:
        value32, locs, atts32, off = _msda_inputs(g, shapes, batch, queries, dev)
        qkv32 = [torch.randn(batch, 3, 4096, 64, generator=g) for _ in range(3)]
        s = sum(h * w for h, w in shapes)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            value = value32.to(dev, dtype)
            cases, extra = {}, {}
            for mode, loc in locs.items():
                att = atts32[mode].to(dev, dtype)
                name = f"msda_{mode}{suffix}"
                cases[name] = (
                    lambda loc=loc, att=att: msda_fwd_cuda(value, shapes, loc, att),
                    lambda loc=loc, att=att: ms_deform_attn(value, shapes, loc, att), None, "msda",
                    {"value": list(value.shape), "queries": loc.shape[1]},
                    msda_bound("msda_fwd", batch, s, loc.shape[1], len(shapes),
                               value.element_size()))
                extra[name] = k1_bodies(value, shapes, loc, att, name, dname)
            att = atts32["encoder"].to(dev, dtype)
            name = f"msda_window{suffix}"
            cases[name] = (
                lambda att=att: msda_fwd_window_cuda(value, shapes, off, att, RADIUS),
                lambda att=att: ms_deform_attn(value, shapes, window_locations(shapes, off, RADIUS),
                                               att), None, "msda",
                {"value": list(value.shape), "queries": s},
                msda_bound("msda_fwd_window", batch, s, s, len(shapes), value.element_size()))
            extra[name] = k1_window(value, shapes, off, locs["encoder"], att, name, dname)
            if with_attn:
                q, k, v = (t.to(dev, dtype) for t in qkv32)
                cases[f"attention{suffix}"] = (
                    lambda: attn_fwd_cuda(q, k, v, 64**-0.5),
                    lambda: global_attention_plain(q, k, v, 64**-0.5),
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=64**-0.5), "attn",
                    {"q": list(q.shape)}, attn_bound("attn_fwd", tuple(q.shape), dname))
            for name, (kernel, plain, library, kind, shape, (bound_ms, bound_by)) in cases.items():
                err = float((kernel().float() - plain().float()).abs().max())
                bound = BOUNDS[dname][kind]
                rec = dict(phase="kernel", name=name, dtype=dname, shape=shape, max_abs_err=err,
                           bound=bound, ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                           library_ms=cuda_ms(library) if library else None, bound_ms=bound_ms,
                           bound_by=bound_by, **extra.get(name, {}))
                log(**rec)
                if not err <= bound:
                    fail(f"{name} {dname}: max |kernel - plain| {err} > {bound}")
                results[(name, dname)] = rec
            del value, cases, extra
        del value32, locs, atts32, qkv32, off
        torch.cuda.empty_cache()
    k1_body_sweep(dev)
    results.update(forms_kernels_step(dev))
    return results


# The window forms' cases: (suffix, pyramid, batch). The kernels line reads
# the protocol's.
FORM_CASES = (("", SHAPES, 1), ("_train", TRAIN_SHAPES, TRAIN_BATCH))
# K8's shared-memory budget, per byte of a value element, that forces its
# D = 32 body's plan into two or more groups at most query levels of both
# pyramids (14-17 launches a layer against 5)
FORCED_GROUP_BUDGET = 12 * 1024


def qlevel_bodies(value, shapes, off, att, k1, name: str, dname: str) -> dict:
    """K8's D = 32 body against K1's window entry and against K1 on
    ``window_locations`` (``k1``) bit for bit, as planned and under
    FORCED_GROUP_BUDGET, and its general body timed beside; the record's
    fields."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import msda_fwd_window_cuda
    from ape_tpu_torch.ops.msda_window_forms import plan_layer, window_form_cuda

    k1w = msda_fwd_window_cuda(value, shapes, off, att, RADIUS)
    budget = FORCED_GROUP_BUDGET * value.element_size()
    runs = {"planned": window_form_cuda("qlevel", value, shapes, off, att, RADIUS, body="d32"),
            "forced_groups": window_form_cuda("qlevel", value, shapes, off, att, RADIUS,
                                              body="d32", budget=budget)}
    grouped = len(plan_layer("qlevel", shapes, HEAD_DIM, value.element_size(), RADIUS, budget))
    for run, got in runs.items():
        for ref, want in (("msda_fwd_window", k1w), ("msda_fwd on window_locations", k1)):
            if not torch.equal(got, want):
                err = float((got.float() - want.float()).abs().max())
                fail(f"{name} {dname}: K8's D = 32 body ({run}) differs from {ref} by {err}")
    return dict(d32_equals_msda_fwd_window=True, forced_group_launches=grouped,
                forced_groups_ms=cuda_ms(lambda: window_form_cuda(
                    "qlevel", value, shapes, off, att, RADIUS, body="d32", budget=budget),
                    FORM_ITERS),
                general_ms=cuda_ms(lambda: window_form_cuda(
                    "qlevel", value, shapes, off, att, RADIUS, body="general"), FORM_ITERS),
                msda_fwd_window_ms=cuda_ms(lambda: msda_fwd_window_cuda(
                    value, shapes, off, att, RADIUS), FORM_ITERS))


def dense_bodies(value, shapes, off, att, name: str, dname: str) -> dict:
    """K9's D = 32 body (bf16) beside its general body: each K9 launch of
    the plan in out mode "store" against the plain version on the same
    inputs upcast to f32, within DENSE_STORE_BOUND of its largest output;
    the whole op under the general body, its error and time; the record's
    fields."""
    import dataclasses

    import torch

    from ape_tpu_torch.ops.bounds import DENSE_STORE_BOUND, FWD_BOUNDS as BOUNDS
    from ape_tpu_torch.ops.msda import level_start_index
    from ape_tpu_torch.ops.msda_window_forms import (
        launch_cuda,
        plan_layer,
        window_form_cuda,
        window_plain,
        window_qlevel_plain,
    )

    starts, _ = level_start_index(shapes)
    store = []
    for x in plan_layer("dense", shapes, HEAD_DIM, value.element_size(), RADIUS):
        if x.kernel != "msda_fwd_dense":
            continue
        if x.body != "d32":
            fail(f"{name} {dname}: a K9 launch of the plan takes the {x.body} body")
        out = torch.zeros(*value.shape[:2], HEADS * HEAD_DIM, device=value.device)
        launch_cuda(dataclasses.replace(x, out_mode="store"), value, shapes, off, att, out, RADIUS)
        (lq,) = x.query_levels
        rows = slice(starts[lq], starts[lq] + shapes[lq][0] * shapes[lq][1])
        want = window_qlevel_plain(value.float(), shapes, lq, off, att.float(), RADIUS)
        store.append(float((out[:, rows] - want).abs().max()) / float(want.abs().max()))
        if not store[-1] <= DENSE_STORE_BOUND:
            fail(f"{name} {dname}: K9's D = 32 body in f32 out mode at query level {lq}: "
                 f"max |kernel - f32 plain| / max |plain| {store[-1]} > {DENSE_STORE_BOUND}")
    general = window_form_cuda("dense", value, shapes, off, att, RADIUS, body="general")
    err = float((general.float() - window_plain(value, shapes, off, att, RADIUS).float())
                .abs().max())
    if not err <= BOUNDS[dname]["msda"]:
        fail(f"{name} {dname}: K9's general body: max |form - plain| {err} > "
             f"{BOUNDS[dname]['msda']}")
    return dict(body="d32", store_rel_err=store, store_bound=DENSE_STORE_BOUND,
                general_max_abs_err=err,
                general_ms=cuda_ms(lambda: window_form_cuda(
                    "dense", value, shapes, off, att, RADIUS, body="general"), FORM_ITERS))


def forms_kernels_step(dev):
    """K6 (all pairs), K7 (+ K6), K8 and K9 (+ K1), each as the whole window
    op of one encoder layer, against the plain version and against K1 on the
    same inputs (the ring draw), at the protocol pyramid (batch 1) and the
    4-scale one (batch 2), in f32 and bf16: errors, times, bound, launches
    per layer; K8's two bodies also by ``qlevel_bodies``, K9's (bf16) by
    ``dense_bodies``."""
    import torch

    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.ops.bounds import FWD_BOUNDS as BOUNDS
    from ape_tpu_torch.ops.msda_dispatch import msda_fwd_cuda, window_locations
    from ape_tpu_torch.ops.msda_window_forms import window_form_cuda, window_plain
    from ape_tpu_torch.tools.msda_race import window_inputs

    g = torch.Generator().manual_seed(SEED + 7)
    results = {}
    for suffix, shapes, batch in FORM_CASES:
        s = sum(h * w for h, w in shapes)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            value, off, att = window_inputs(g, shapes, batch, "ring", dtype, dev)
            plain = window_plain(value, shapes, off, att, RADIUS)
            plain_ms = cuda_ms(lambda: window_plain(value, shapes, off, att, RADIUS), FORM_ITERS)
            k1 = msda_fwd_cuda(value, shapes, window_locations(shapes, off, RADIUS).contiguous(),
                               att)
            bound_ms, bound_by = msda_bound("msda_fwd", batch, s, s, len(shapes),
                                            value.element_size())
            limit = BOUNDS[dname]["msda"]
            for form in WINDOW_FORMS:
                name = f"msda_fwd_{form}{suffix}"
                before = dict(_build.LAUNCHES)
                got = window_form_cuda(form, value, shapes, off, att, RADIUS)
                launches = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
                err = float((got.float() - plain.float()).abs().max())
                err_k1 = float((got.float() - k1.float()).abs().max())
                rec = dict(phase="kernel_form", name=name, dtype=dname, batch=batch, tokens=s,
                           max_abs_err=err, max_abs_err_vs_msda_fwd=err_k1, bound=limit,
                           launches_per_layer=launches,
                           ms=cuda_ms(lambda: window_form_cuda(form, value, shapes, off, att,
                                                               RADIUS), FORM_ITERS),
                           plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                           bound_by=bound_by)
                if form == "qlevel":
                    rec.update(qlevel_bodies(value, shapes, off, att, k1, name, dname))
                if form == "dense" and dtype == torch.bfloat16:
                    rec.update(dense_bodies(value, shapes, off, att, name, dname))
                log(**rec)
                if not (err <= limit and err_k1 <= limit):
                    fail(f"{name} {dname}: max |form - plain| {err}, |form - K1| {err_k1} > {limit}")
                results[(name, dname)] = rec
            del value, off, att, plain, k1
            torch.cuda.empty_cache()
    return results


def _errors(names, got, want):
    """{output: (max |got - want|, that over max |want|)}, each output on its own."""
    out = {}
    for n, g, w in zip(names, got, want):
        err = float((g.float() - w.float()).abs().max())
        out[n] = (err, err / max(float(w.abs().max()), 1e-30))
    return out


# K2's general body takes every head width but 32, which no model of the
# repo has; the backward phase holds it to its bounds at the decoder's
# training shape at this width.
K2_GENERAL_HEAD_DIM = 64


def backward_kernels_phase(dev):
    """Each backward kernel against torch autograd of its plain version at the
    training shapes: errors against the plain version in f32 on the same
    inputs, times against the plain backward in the same dtype; K2 at
    HEAD_DIM (its D = 32 body) and at K2_GENERAL_HEAD_DIM (its general
    body). The attention backward's library yardstick is SDPA's whole
    backward, timed as the device time of its kernels (``kernel_ms``), with
    the port's beside it timed the same way. Returns per-case results at
    bf16."""
    import torch

    from ape_tpu_torch.ops.attention import (
        attn_bwd_dkv_cuda,
        attn_bwd_dq_cuda,
        attn_fwd_cuda,
        global_attention_plain,
    )
    from ape_tpu_torch.ops.bounds import GRAD_BOUNDS, SPLIT_BOUNDS
    from ape_tpu_torch.ops.msda import ms_deform_attn
    import torch.nn.functional as F

    from ape_tpu_torch.ops.msda_dispatch import (
        msda_bwd_cuda,
        msda_bwd_offatt_cuda,
        msda_bwd_value_cuda,
    )

    g = torch.Generator().manual_seed(SEED + 3)
    b = TRAIN_BATCH
    value32, locs, atts, _ = _msda_inputs(g, TRAIN_SHAPES, b, TRAIN_QUERIES, dev)
    # (value f32 on the CPU, locations on dev, weights, upstream grad) per case
    msda_cases = {f"msda_bwd_{mode}": [value32, loc, atts[mode]] for mode, loc in locs.items()}
    for case in msda_cases.values():
        case.append(torch.randn(b, case[1].shape[1], HEADS * HEAD_DIM, generator=g))
    qkvo32 = [torch.randn(TRAIN_BATCH, 3, 4096, 64, generator=g) for _ in range(4)]
    wide = K2_GENERAL_HEAD_DIM
    msda_cases[f"msda_bwd_decoder_d{wide}"] = [
        torch.randn(b, value32.shape[1], HEADS, wide, generator=g), locs["decoder"],
        atts["decoder"], torch.randn(b, TRAIN_QUERIES, HEADS * wide, generator=g)]
    scale = 64**-0.5

    results = {}

    def record(name, dname, errors, kernel, plain, bound_ms, vs_merged=None, library=None,
               extra=None):
        rec = dict(phase="kernel_bwd", name=name, dtype=dname,
                   max_abs_err=max(e[0] for e in errors.values()),
                   abs_err={n: e[0] for n, e in errors.items()},
                   rel_err={n: e[1] for n, e in errors.items()}, bound=GRAD_BOUNDS[dname],
                   ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                   library_ms=kernel_ms(library) if library else None,
                   bound_ms=bound_ms[0], bound_by=bound_ms[1])
        if library:  # both timed alike, and the library's by events too
            rec.update(kernel_device_ms=kernel_ms(kernel), library_event_ms=cuda_ms(library))
        if vs_merged is not None:
            rec.update(rel_err_vs_msda_bwd={n: e[1] for n, e in vs_merged.items()},
                       bound_vs_msda_bwd=SPLIT_BOUNDS[dname])
        rec.update(extra or {})
        log(**rec)
        for n, (_, rel) in errors.items():
            if not rel <= GRAD_BOUNDS[dname]:
                fail(f"{name} {dname}: {n}: max |kernel - autograd of plain| / max |plain| {rel} "
                     f"> {GRAD_BOUNDS[dname]}")
        for n, (_, rel) in (vs_merged or {}).items():
            if not rel <= SPLIT_BOUNDS[dname]:
                fail(f"{name} {dname}: {n}: max |split - merged| / max |merged| {rel} "
                     f"> {SPLIT_BOUNDS[dname]}")
        results[(name, dname)] = rec

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        lv = len(TRAIN_SHAPES)
        for name, (value, loc, att, gout) in msda_cases.items():
            value, att, gout = (t.to(dev, dtype) for t in (value, att, gout))
            (_, s, _, d), nq, es = value.shape, loc.shape[1], value.element_size()
            merged = msda_bwd_cuda(value, TRAIN_SHAPES, loc, att, gout)
            leaves = [value.detach().float().requires_grad_(), loc.detach().clone().requires_grad_(),
                      att.detach().float().requires_grad_()]
            want = torch.autograd.grad(ms_deform_attn(leaves[0], TRAIN_SHAPES, *leaves[1:]),
                                       leaves, gout.float())
            err = _errors(("d_value", "d_loc", "d_att"), merged, want)
            split = None
            if name == "msda_bwd_encoder":  # the split form serves the encoder only
                # K3's D = 32 body: K2's d_loc and d_att bit for bit; its
                # general body within bounds of autograd and of K2
                offatt = msda_bwd_offatt_cuda(value, TRAIN_SHAPES, loc, att, gout, body="d32")
                general = msda_bwd_offatt_cuda(value, TRAIN_SHAPES, loc, att, gout,
                                               body="general")
                for out_name, got, ref in zip(("d_loc", "d_att"), offatt, merged[1:]):
                    if not torch.equal(got, ref):
                        err = float((got.float() - ref.float()).abs().max())
                        fail(f"msda_bwd_offatt {dname}: the D = 32 body's {out_name} differs "
                             f"from K2's by {err}")
                # K4's D = 32 body: K2's d_value within the split bound (the
                # same addends, the atomics in another order); its general
                # body within bounds of autograd and of K2
                d_value = msda_bwd_value_cuda(TRAIN_SHAPES, loc, att, gout, body="d32")
                value_general = msda_bwd_value_cuda(TRAIN_SHAPES, loc, att, gout, body="general")
                split = {"msda_bwd_offatt": (_errors(("d_loc", "d_att"), offatt, want[1:]),
                                             _errors(("d_loc", "d_att"), general, merged[1:])),
                         "msda_bwd_value": (_errors(("d_value",), [d_value], want[:1]),
                                            _errors(("d_value",), [d_value], merged[:1]))}
                general_errs = _errors(("d_loc", "d_att"), general, want[1:])
                value_general_errs = (_errors(("d_value",), [value_general], want[:1]),
                                      _errors(("d_value",), [value_general], merged[:1]))
                for kname, (errs, vs) in (("msda_bwd_offatt", (general_errs, {})),
                                          ("msda_bwd_value", value_general_errs)):
                    for n, (_, rel) in errs.items():
                        if not rel <= GRAD_BOUNDS[dname]:
                            fail(f"{kname} {dname}: the general body's {n}: max |kernel - "
                                 f"autograd of plain| / max |plain| {rel} > {GRAD_BOUNDS[dname]}")
                    for n, (_, rel) in vs.items():
                        if not rel <= SPLIT_BOUNDS[dname]:
                            fail(f"{kname} {dname}: the general body's {n}: max |split - merged|"
                                 f" / max |merged| {rel} > {SPLIT_BOUNDS[dname]}")
                del offatt, general, d_value, value_general
            del merged, leaves, want
            plain_leaves = [t.detach().clone().requires_grad_() for t in (value, loc, att)]
            out = ms_deform_attn(plain_leaves[0], TRAIN_SHAPES, *plain_leaves[1:])

            def plain_bwd(*which):  # autograd of the plain version for these of (value, loc, att)
                return lambda: torch.autograd.grad(out, [plain_leaves[i] for i in which], gout,
                                                   retain_graph=True)

            record(name, dname, err, lambda: msda_bwd_cuda(value, TRAIN_SHAPES, loc, att, gout),
                   plain_bwd(0, 1, 2), msda_bound("msda_bwd", b, s, nq, lv, es, d))
            if split is not None:
                errs, vs = split["msda_bwd_offatt"]
                record("msda_bwd_offatt", dname, errs,
                       lambda: msda_bwd_offatt_cuda(value, TRAIN_SHAPES, loc, att, gout),
                       plain_bwd(1, 2), msda_bound("msda_bwd_offatt", b, s, nq, lv, es), vs,
                       extra=dict(
                           d32_equals_msda_bwd=True, vs_msda_bwd_body="general",
                           general_rel_err={n: e[1] for n, e in general_errs.items()},
                           general_ms=cuda_ms(lambda: msda_bwd_offatt_cuda(
                               value, TRAIN_SHAPES, loc, att, gout, body="general"))))
                errs, vs = split["msda_bwd_value"]
                record("msda_bwd_value", dname, errs,
                       lambda: msda_bwd_value_cuda(TRAIN_SHAPES, loc, att, gout), plain_bwd(0),
                       msda_bound("msda_bwd_value", b, s, nq, lv, es), vs,
                       extra=dict(
                           body="d32",
                           general_rel_err={n: e[1] for n, e in value_general_errs[0].items()},
                           general_rel_err_vs_msda_bwd={
                               n: e[1] for n, e in value_general_errs[1].items()},
                           general_ms=cuda_ms(lambda: msda_bwd_value_cuda(
                               TRAIN_SHAPES, loc, att, gout, body="general"))))
            del value, att, gout, out, plain_leaves
            torch.cuda.empty_cache()

        q, k, v, go = (t.to(dev, dtype) for t in qkvo32)
        out, lse = attn_fwd_cuda(q, k, v, scale, with_lse=True)
        dq, delta = attn_bwd_dq_cuda(q, k, v, out, go, lse, scale)
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(global_attention_plain(*leaves, scale), leaves, go.float())
        plain_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        plain_out = global_attention_plain(*plain_leaves, scale)

        def plain_bwd(*which):  # autograd of the plain version for these of (q, k, v)
            return lambda: torch.autograd.grad(plain_out, [plain_leaves[i] for i in which], go,
                                               retain_graph=True)

        def kernel_bwd():  # the attention backward's two launches, as the train path runs them
            dq_, d = attn_bwd_dq_cuda(q, k, v, out, go, lse, scale)
            return (dq_, *attn_bwd_dkv_cuda(q, k, v, go, lse, d, scale))

        # the library yardstick: scaled_dot_product_attention's whole
        # backward (dQ, dK, dV), beside K5-dkv and K5-dq; timed by its
        # kernels' device time, as autograd's host time between them would
        # otherwise count (record)
        lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_leaves, scale=scale)

        def lib_bwd():
            return torch.autograd.grad(lib_out, lib_leaves, go, retain_graph=True)

        shape = tuple(q.shape)
        record("attn_bwd_dkv", dname,
               _errors(("dk", "dv"), attn_bwd_dkv_cuda(q, k, v, go, lse, delta, scale), want[1:]),
               lambda: attn_bwd_dkv_cuda(q, k, v, go, lse, delta, scale), plain_bwd(1, 2),
               attn_bound("attn_bwd_dkv", shape, dname), library=lib_bwd)
        # dQ against autograd, and the delta it writes against the plain row
        # sum of O * dO (f32 sums of 64 products in two orders)
        record("attn_bwd_dq", dname,
               _errors(("dq", "delta"), [dq, delta], [want[0], (out.float() * go.float()).sum(-1)]),
               lambda: attn_bwd_dq_cuda(q, k, v, out, go, lse, scale), plain_bwd(0),
               attn_bound("attn_bwd_dq", shape, dname), library=lib_bwd)
        record("attn_bwd", dname, _errors(("dq", "dk", "dv"), kernel_bwd(), want),
               kernel_bwd, plain_bwd(0, 1, 2), attn_bound("attn_bwd", shape, dname),
               library=lib_bwd)
        del out, lse, dq, delta, leaves, want, plain_leaves, plain_out, lib_leaves, lib_out
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
    from ape_tpu_torch.ops import _build, nms

    model = build_ape_ti(num_queries=QUERIES, mask_on=False, window_radius=RADIUS,
                         scale_factors=(2.0, 1.0, 0.5), dtype=torch.bfloat16)
    model = init_weights(model, SEED).eval()
    inputs = tuple(t.to(dev) for t in _inputs())
    with torch.no_grad():
        model(*inputs)  # warm-up: builds the constant tables (ops/tables.py)
        torch.cuda.synchronize()
        _build.reset_launches()
        nms.SYNCS["fixpoint"] = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = model(*inputs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        if launches != dict(dict.fromkeys(launches, 0), **FORWARD_LAUNCHES):
            fail(f"launches per forward {launches}, expected {FORWARD_LAUNCHES}")
        logits, boxes = out["pred_logits"], out["pred_boxes"]
        if tuple(logits.shape) != (1, QUERIES, NUM_TEXT) or tuple(boxes.shape) != (1, QUERIES, 4):
            fail(f"output shapes {tuple(logits.shape)} {tuple(boxes.shape)}")
        if not (torch.isfinite(logits).all() and torch.isfinite(boxes).all()):
            fail("non-finite outputs")
        syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
        # every host sync of a forward is the NMS fixpoint's loop test: a
        # table copied to the card at each call (F5) would add its own
        nms_syncs = nms.SYNCS["fixpoint"]
        if syncs != nms_syncs:
            fail(f"host syncs per forward {syncs}, the NMS fixpoint's tests {nms_syncs}")

        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            model(*inputs)
        torch.cuda.synchronize()
        img_s = iters / (time.perf_counter() - t0)
    log(phase="slice", dtype="bfloat16", launches_per_forward=launches,
        host_syncs_per_forward=syncs, nms_fixpoint_syncs=nms_syncs,
        logits_shape=list(logits.shape),
        boxes_shape=list(boxes.shape), images_per_s=img_s, iters=iters, card=card)
    return model, launches


def _set_form(form: str):
    """Select the encoder's window forward form through msda_dispatch's flags
    (both off for "gather")."""
    from ape_tpu_torch.ops import msda_dispatch

    for f, flag in FORM_FLAGS.items():
        setattr(msda_dispatch, flag, f == form)


def forms_phase(model, dev, card):
    """The protocol forward in bf16 under FUSED (K8) and under V6 (K9 + K1):
    exact launches per forward, finite outputs of the right shapes, images/s.
    Returns the launches of the measured forwards."""
    import torch

    from ape_tpu_torch.ops import _build

    inputs = tuple(t.to(dev) for t in _inputs())
    runs = []
    for form in FORM_FLAGS:
        want = with_form(FORWARD_LAUNCHES, form, SHAPES, 2)
        _set_form(form)
        try:
            with torch.no_grad():
                model(*inputs)  # warm-up
                torch.cuda.synchronize()
                _build.reset_launches()
                out = model(*inputs)
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)
                iters = 10
                t0 = time.perf_counter()
                for _ in range(iters):
                    model(*inputs)
                torch.cuda.synchronize()
                img_s = iters / (time.perf_counter() - t0)
        finally:
            _set_form("gather")
        if launches != dict(dict.fromkeys(launches, 0), **want):
            fail(f"form {form}: launches per forward {launches}, expected {want}")
        logits, boxes = out["pred_logits"], out["pred_boxes"]
        if tuple(logits.shape) != (1, QUERIES, NUM_TEXT) or tuple(boxes.shape) != (1, QUERIES, 4) \
                or not (torch.isfinite(logits).all() and torch.isfinite(boxes).all()):
            fail(f"form {form}: outputs {tuple(logits.shape)} {tuple(boxes.shape)} or not finite")
        log(phase="forms", form=form, flag=FORM_FLAGS[form], dtype="bfloat16",
            launches_per_forward={k: v for k, v in launches.items() if v}, images_per_s=img_s,
            iters=iters, card=card)
        runs.append(launches)
    return runs


def f32_phase(model):
    """The same forward in f32, CUDA kernels against the plain versions (CPU
    tensors take them), with fan-in weights: under the bench's N(0, 0.02)
    weights the first-stage scores are spread so thinly that float order
    alone reorders near-ties, which would test the weights, not the kernels."""
    import torch

    from ape_tpu_torch.ops import _build

    init_weights(model, SEED, fan_in=True)
    model.dtype = torch.float32
    cpu_model = copy.deepcopy(model).cpu()
    inputs = _inputs()
    dev = next(model.parameters()).device
    with torch.no_grad():
        t0 = time.perf_counter()
        gpu = model(*(t.to(dev) for t in inputs))
        cpu = cpu_model(*inputs)
    forms = {}
    for form in FORM_FLAGS:  # the encoder memory under each other form, f32
        _set_form(form)
        _build.reset_launches()
        try:
            with torch.no_grad():
                memory = model(*(t.to(dev) for t in inputs))["memory"]
        finally:
            _set_form("gather")
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        want = with_form(FORWARD_LAUNCHES, form, SHAPES, 4)
        forms[form] = dict(memory_max_abs_err=float((memory.cpu() - cpu["memory"]).abs().max()),
                           launches_per_forward=launches)
        if launches != want:
            fail(f"f32 form {form}: launches per forward {launches}, expected {want}")
        if not forms[form]["memory_max_abs_err"] <= MEMORY_BOUND:
            fail(f"f32 form {form}: encoder memory differs by "
                 f"{forms[form]['memory_max_abs_err']} > {MEMORY_BOUND}")
    mem_err = float((gpu["memory"].cpu() - cpu["memory"]).abs().max())
    sel_gpu, sel_cpu = gpu["first_stage_indices"].cpu(), cpu["first_stage_indices"]
    same_sel = bool(torch.equal(sel_gpu, sel_cpu))
    log(phase="slice_f32_vs_plain", memory_max_abs_err=mem_err, memory_bound=MEMORY_BOUND,
        memory_max_abs=float(cpu["memory"].abs().max()),
        first_stage_indices_identical=same_sel,
        first_stage_positions_differing=int((sel_gpu != sel_cpu).sum()),
        pred_boxes_max_abs_err=float((gpu["pred_boxes"].cpu() - cpu["pred_boxes"]).abs().max()),
        pred_logits_max_abs_err=float((gpu["pred_logits"].cpu() - cpu["pred_logits"]).abs().max()),
        forms=forms, seconds=time.perf_counter() - t0)
    if not mem_err <= MEMORY_BOUND:
        fail(f"f32 encoder memory differs by {mem_err} > {MEMORY_BOUND}")
    if not same_sel:
        fail("f32 first-stage indices differ between the CUDA kernels and the plain versions")


def _train_batch(dev, batch: int, img: int, seed: int, masks: bool = False):
    """Seeded inputs and targets as tools/bench_train.py draws them: 80 texts
    of width 1024; 8 target slots per image, 4 valid, labels in [0, 80),
    cxcywh boxes uniform in [0.2, 0.6); with ``masks`` GT masks at img / 4
    drawn as rand > 0.7."""
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
    if masks:
        out["targets"]["masks"] = torch.rand(batch, slots, img // 4, img // 4, generator=g) > 0.7
    return _to(out, dev)


def _to(batch, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev)) for k, v in batch.items()}


def _criterion(queries: int, mask_on: bool):
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict

    return DeformableCriterion(num_classes=NUM_TEXT, weight_dict=default_weight_dict(),
                               num_queries=queries,
                               losses=("class", "boxes", "masks") if mask_on else ("class", "boxes"))


def _train_setup(dev, mask_on: bool):
    """APE-Ti for bf16 training at 1024^2 with recompute checkpointing, its
    optimizer and train step, and a seeded batch: (model, step, batch)."""
    import torch

    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.modeling.build import build_ape_ti

    model = build_ape_ti(num_queries=TRAIN_QUERIES, window_radius=RADIUS, mask_on=mask_on,
                         use_act_checkpoint=True, dtype=torch.bfloat16)
    model = init_weights(model, SEED)
    optimizer, scheduler = build_optimizer(model)
    step = make_train_step(model, _criterion(TRAIN_QUERIES, mask_on), optimizer, scheduler)
    batch = _train_batch(dev, TRAIN_BATCH, TRAIN_IMG, SEED + 4, masks=mask_on)
    return model, step, batch


def _train_steps(model, step, batch, dev, per_step, steps: int = TRAIN_STEPS):
    """One warm-up step, whose losses and every parameter's gradient must be
    finite, then ``steps`` timed steps with the launch counts set to 0 just
    before them and held to ``per_step`` each. Returns the record's fields."""
    import torch

    from ape_tpu_torch.ops import _build

    gen = torch.Generator(device=dev).manual_seed(SEED)
    metrics = step(batch, gen)  # warm-up
    torch.cuda.synchronize()
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
    no_grad = [n for n, p in model.named_parameters()
               if p.requires_grad and (p.grad is None or not bool(torch.isfinite(p.grad).all()))]
    if bad or no_grad:
        fail(f"warm-up step: non-finite {bad}; missing or non-finite gradients {no_grad[:10]}")

    torch.cuda.reset_peak_memory_stats(dev)
    want = {k: steps * per_step.get(k, 0) for k in _build.LAUNCHES}
    _build.reset_launches()
    seconds = []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
        if bad:
            fail(f"non-finite train metrics {bad}")
    launches = dict(_build.LAUNCHES)
    if launches != want:
        fail(f"launches over {steps} train steps {launches}, expected {want}")
    s_step = sum(seconds) / len(seconds)
    return dict(steps=steps, seconds_per_step=seconds, s_per_step=s_step,
                images_per_s=TRAIN_BATCH / s_step,
                max_memory_allocated_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                launches=launches, launches_per_step={k: v // steps for k, v in launches.items()},
                losses={k: float(v) for k, v in metrics.items()})


def train_phase(dev, card):
    """APE-Ti detection training at 1024^2, batch 2, bf16, with recompute
    checkpointing: finite losses and gradients, launches per step, s/step,
    peak memory."""
    model, step, batch = _train_setup(dev, mask_on=False)
    rec = _train_steps(model, step, batch, dev, STEP_LAUNCHES)
    launches = rec.pop("launches")
    log(phase="train", dtype="bfloat16", image=TRAIN_IMG, batch=TRAIN_BATCH, queries=TRAIN_QUERIES,
        tokens=sum(h * w for h, w in TRAIN_SHAPES), **rec, card=card)
    # under FUSED: K8 in the encoder's forward and in its recompute, K2 backward
    _set_form("qlevel")
    try:
        fused = _train_steps(model, step, batch, dev,
                             with_form(STEP_LAUNCHES, "qlevel", TRAIN_SHAPES, 2, passes=2), steps=1)
    finally:
        _set_form("gather")
    fused_launches = fused.pop("launches")
    log(phase="train_fused", form="qlevel", dtype="bfloat16", image=TRAIN_IMG, batch=TRAIN_BATCH,
        **fused, card=card)
    return launches, fused_launches


def full_train_phase(dev, card):
    """The masked model's bf16 training as tools/bench_train.py runs it, with
    the merged MSDA backward and then the split one: per form, finite losses
    (the mask losses among them) and gradients, exact launches, s/step, peak
    memory. Returns the launches of each form: (merged, split)."""
    from ape_tpu_torch.ops import msda_dispatch

    model, step, batch = _train_setup(dev, mask_on=True)
    runs = []
    for merged, per_step in ((True, STEP_LAUNCHES), (False, SPLIT_STEP_LAUNCHES)):
        msda_dispatch.BWD_MERGED = merged
        try:
            rec = _train_steps(model, step, batch, dev, per_step)
        finally:
            msda_dispatch.BWD_MERGED = True
        missing = [k for k in ("loss_mask", "loss_dice") if k not in rec["losses"]]
        if missing:
            fail(f"full train step ({'merged' if merged else 'split'}): no {missing}")
        runs.append(rec.pop("launches"))
        log(phase="full_train", msda_backward="merged" if merged else "split", dtype="bfloat16",
            image=TRAIN_IMG, batch=TRAIN_BATCH, queries=TRAIN_QUERIES,
            tokens=sum(h * w for h, w in TRAIN_SHAPES), masks=list(batch["targets"]["masks"].shape),
            **rec, card=card)
    return tuple(runs)


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


def train_f32_phase(dev, mask_on: bool = False):
    """One f32 step (512^2, batch 1, fan-in weights) with the CUDA kernels,
    every parameter's gradient held against the plain versions on the CPU
    within its bound; the first-stage indices must match. Then the plain
    version against itself on perturbed images: the gradients' floor. The
    detection model runs the protocol pyramid; the masked model (mask_on) the
    default one, and its step runs once more with the split MSDA backward,
    held against the merged one."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti
    from ape_tpu_torch.ops import _build, msda_dispatch

    pyramid = {} if mask_on else {"scale_factors": (2.0, 1.0, 0.5)}
    model = build_ape_ti(num_queries=TRAIN_QUERIES, window_radius=RADIUS, mask_on=mask_on,
                         use_act_checkpoint=True, **pyramid)
    model = init_weights(model, SEED, fan_in=True).train()
    if mask_on:
        # The encoder's sampling_offsets weights at 0, as the reference
        # initialises them: the samples then sit where the biases put them,
        # whatever the activations, and the 4-scale encoder's 4x more samples
        # add no crossings of integer pixels to the floor (phase 9 keeps the
        # fan-in weights there).
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith("transformer.encoder.") and name.endswith("sampling_offsets.weight"):
                    p.zero_()
    cpu_model = copy.deepcopy(model).cpu()
    crit = _criterion(TRAIN_QUERIES, mask_on)
    batch = _train_batch("cpu", 1, F32_TRAIN_IMG, SEED + 5, masks=mask_on)
    gpu_batch = _to(batch, dev)
    t0 = time.perf_counter()
    gpu_total, gpu_sel, gpu_grads = step_grads(model, crit, gpu_batch, SEED)
    split = {}
    if mask_on:
        msda_dispatch.BWD_MERGED = False
        _build.reset_launches()
        try:
            _, split_sel, split_grads = step_grads(model, crit, gpu_batch, SEED)
        finally:
            msda_dispatch.BWD_MERGED = True
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        if launches != SPLIT_STEP_LAUNCHES or not torch.equal(split_sel, gpu_sel):
            fail(f"f32 split step: launches {launches}, expected {SPLIT_STEP_LAUNCHES}; "
                 f"first-stage indices as the merged step's: {torch.equal(split_sel, gpu_sel)}")
        split = grad_rel_errors(split_grads, gpu_grads)
        del split_grads
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
    rec = {}
    if mask_on:
        rec = dict(split_worst_grad_rel_err=sorted(split.items(), key=lambda kv: -kv[1])[:3],
                   split_bound=F32_SPLIT_RTOL)
    log(phase="full_train_f32_vs_plain" if mask_on else "train_f32_vs_plain", image=F32_TRAIN_IMG,
        total_loss_cuda=gpu_total,
        total_loss_cpu=cpu_total, first_stage_indices_identical=same_sel, params=len(rel),
        worst_grad_rel_err=worst(rel, False), bound=F32_GRAD_RTOL,
        worst_offset_grad_rel_err=worst(rel, True), offset_bound=F32_OFFSET_GRAD_RTOL,
        perturbation=PERTURB, floor_first_stage_indices_identical=bool(torch.equal(floor_sel, cpu_sel)),
        floor_worst_grad_rel_err=worst(floor, False), floor_worst_offset_grad_rel_err=worst(floor, True),
        **rec, seconds=time.perf_counter() - t0)
    if not same_sel:
        fail("f32 train step: first-stage indices differ between the CUDA kernels and the plain versions")
    if over:
        fail(f"f32 train step: {len(over)} gradients over their bound, worst (name, rel, bound) {over[:3]}")
    split_over = [(n, r) for n, r in split.items() if not r <= F32_SPLIT_RTOL]
    if split_over:
        fail(f"f32 split step: {len(split_over)} gradients differ from the merged step's by more "
             f"than {F32_SPLIT_RTOL}, e.g. {split_over[:3]}")


class StubLanguage:
    """Stands in for the text tower: a seeded feature per text (width 1024)."""

    def forward_text(self, text_list, cache=False):
        import numpy as np

        return np.stack([np.random.RandomState(zlib.crc32(t.encode())).randn(1024)
                         for t in text_list]).astype(np.float32)


def _check_mask_outputs(res, h, w):
    """A masked model's request: finite instance mask logits, one per kept
    instance, and finite sem_seg maps over the padded vocabulary, both at the
    mask-feature resolution of the 1024^2 canvas. Returns sem_seg's shape."""
    import torch

    masks, n = res["instances"]["mask_logits"], int(res["instances"]["scores"].numel())
    if tuple(masks.shape) != (n, MASK_SIDE, MASK_SIDE) or not bool(torch.isfinite(masks).all()):
        fail(f"request {h}x{w}: mask_logits {tuple(masks.shape)} for {n} instances, or not finite")
    sem = res["sem_seg"]
    if (sem.dim() != 3 or sem.shape[0] < len(res["text_list"])
            or tuple(sem.shape[1:]) != (MASK_SIDE, MASK_SIDE) or not bool(torch.isfinite(sem).all())):
        fail(f"request {h}x{w}: sem_seg {tuple(sem.shape)} for {len(res['text_list'])} texts, "
             f"or not finite")
    return list(sem.shape)


def serve_phase(model, phase: str = "serve"):
    """Three non-square requests through DefaultPredictor: finite boxes inside
    the image, classes inside the prompt, and for a masked model the mask
    outputs; the launches of the requests."""
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
    for (h, w), prompt in requests:
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        res = predictor(image, prompt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        inst = res["instances"]
        n = int(inst["scores"].numel())
        boxes = inst["boxes"]
        if not bool(torch.isfinite(boxes).all()) or (n and (boxes[:, 2:] > boxes.new_tensor([w, h]) + 1.0).any()):
            fail(f"request {h}x{w}: boxes not finite or outside the image")
        if n and int(inst["classes"].max()) >= len(res["text_list"]):
            fail(f"request {h}x{w}: class index outside the prompt")
        masks = {"sem_seg_shape": _check_mask_outputs(res, h, w)} if model.mask_on else {}
        log(phase=phase, image=[h, w], prompt=prompt, prompt_type=res["prompt_type"],
            instances=n, **masks, seconds=seconds)
    launches = dict(_build.LAUNCHES)
    want = dict(dict.fromkeys(launches, 0),
                **{k: v * len(requests) for k, v in FORWARD_LAUNCHES.items()})
    if launches != want:
        fail(f"{phase} launches {launches}, expected {want}")
    return launches


def full_serve_phase(dev, card):
    """``build_ape_ti()`` with its defaults (the masked model, 4-scale pyramid)
    in bf16 at 1024^2 with 900 queries and N(0, 0.02) weights: launches per
    forward, finite outputs with pred_masks (1, 900, 256, 256), images/s over
    10 forwards; then a forward under ``V6`` and three predictor requests.
    Returns the launches of the measured forward and the requests (default
    flags) and of the forward under V6."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti
    from ape_tpu_torch.ops import _build

    model = build_ape_ti(num_queries=QUERIES, window_radius=RADIUS, dtype=torch.bfloat16)
    model = init_weights(model, SEED).eval()
    inputs = tuple(t.to(dev) for t in _inputs())
    with torch.no_grad():
        model(*inputs)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        out = model(*inputs)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        if launches != dict(dict.fromkeys(launches, 0), **FORWARD_LAUNCHES):
            fail(f"full model: launches per forward {launches}, expected {FORWARD_LAUNCHES}")
        shapes = {k: tuple(out[k].shape) for k in ("pred_logits", "pred_boxes", "pred_masks")}
        want = {"pred_logits": (1, QUERIES, NUM_TEXT), "pred_boxes": (1, QUERIES, 4),
                "pred_masks": (1, QUERIES, MASK_SIDE, MASK_SIDE)}
        if shapes != want:
            fail(f"full model: output shapes {shapes}, expected {want}")
        if not all(bool(torch.isfinite(out[k]).all()) for k in want):
            fail("full model: non-finite outputs")
        del out
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            model(*inputs)
        torch.cuda.synchronize()
        img_s = iters / (time.perf_counter() - t0)
        _set_form("dense")  # V6: the 256- and 128-wide query levels take K9
        try:
            model(*inputs)  # warm-up
            torch.cuda.synchronize()
            _build.reset_launches()
            out = model(*inputs)
            torch.cuda.synchronize()
            dense = dict(_build.LAUNCHES)
        finally:
            _set_form("gather")
        want_dense = with_form(FORWARD_LAUNCHES, "dense", TRAIN_SHAPES, 2)
        if dense != dict(dict.fromkeys(dense, 0), **want_dense):
            fail(f"full model under V6: launches per forward {dense}, expected {want_dense}")
        if not all(bool(torch.isfinite(out[k]).all()) for k in want):
            fail("full model under V6: non-finite outputs")
        del out
    log(phase="full_serve", dtype="bfloat16", image=IMG, queries=QUERIES,
        tokens=sum(h * w for h, w in TRAIN_SHAPES), launches_per_forward=launches,
        output_shapes=shapes, images_per_s=img_s, iters=iters,
        v6_launches_per_forward={k: v for k, v in dense.items() if v}, card=card)
    served = serve_phase(model, "full_serve_request")
    return {k: v + served[k] for k, v in launches.items()}, dense


def race_phase(dev, card):
    """``ape_tpu_torch.tools.msda_race`` as a path of its own: every
    window-MSDA form at both pyramids and offset draws, then the per-pair
    suites; then ``msda_bwd_race``'s backward forms, each within its bound;
    one line each. Returns the launches of the races."""
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import msda_bwd_race
    from ape_tpu_torch.tools.msda_race import race

    _build.reset_launches()
    t0 = time.perf_counter()
    recs = race(dev, card, iters=FORM_ITERS)
    bwd = msda_bwd_race.race(dev, card, iters=FORM_ITERS)
    launches = dict(_build.LAUNCHES)
    bad = msda_bwd_race.failures(bwd)
    if bad:
        fail(f"backward race: {'; '.join(bad)}")
    log(phase="race_done", records=len(recs) + len(bwd), seconds=time.perf_counter() - t0,
        launches={k: v for k, v in launches.items() if v})
    return launches


def probes_phase(dev, card):
    """The two probes as a path of their own, one line a record: K10's
    variants on the four pairs and K11's tiles, each within its bound of its
    plain version, K10 base equal to K1 on each pair and K11 (64, 64) to K5.
    Returns the probes' launches and the kernels line's K10 row (base on the
    256^2 pair) and K11 row (the fastest tile)."""
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import backbone_fix_probe, pair_probe

    _build.reset_launches()
    t0 = time.perf_counter()
    pairs = pair_probe.probe(dev, card, iters=FORM_ITERS)
    attn = backbone_fix_probe.probe(dev, card, iters=FORM_ITERS)
    launches = dict(_build.LAUNCHES)
    # each variant and tile within its bounds of its plain version (the
    # tools' BOUND, BF16FMA_VS_BASE, bf16_steps and F32_BOUND), K10 base = K1
    # and K11 (64, 64) = K5 bit for bit
    bad = pair_probe.failures(pairs) + backbone_fix_probe.failures(attn)
    if bad:
        fail(f"probes: {'; '.join(bad)}")
    base = {r["pair"]: r for r in pairs if r["phase"] == "probe_pair" and r["variant"] == "base"}
    tiles = [r for r in attn if r["name"].startswith("tile_") and r["fits"]]
    log(phase="probes_done", records=len(pairs) + len(attn), seconds=time.perf_counter() - t0,
        launches={k: v for k, v in launches.items() if v})
    return launches, {"msda_pair_probe": base["same"],
                      "attn_fwd_tiles": min(tiles, key=lambda r: r["ms"])}


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
    # launches over every run: each phase sets the counts to 0 just before
    # its run and reads them just after. The serving and training phases are
    # the main paths: those with the default flags (FUSED and V6 off, the
    # merged backward), and those under another form; the race and the
    # probes are paths of their own.
    default_runs, flag_runs = [], []
    model, slice_launches = slice_phase(dev, card)
    default_runs += [slice_launches, serve_phase(model)]
    flag_runs += forms_phase(model, dev, card)
    f32_phase(model)
    del model
    torch.cuda.empty_cache()
    train_launches, fused_launches = train_phase(dev, card)
    default_runs.append(train_launches)
    flag_runs.append(fused_launches)
    train_f32_phase(dev)
    torch.cuda.empty_cache()
    full_serve_launches, v6_launches = full_serve_phase(dev, card)
    default_runs.append(full_serve_launches)
    flag_runs.append(v6_launches)
    torch.cuda.empty_cache()
    merged_launches, split_launches = full_train_phase(dev, card)
    default_runs.append(merged_launches)
    flag_runs.append(split_launches)
    torch.cuda.empty_cache()
    train_f32_phase(dev, mask_on=True)
    torch.cuda.empty_cache()
    main_runs = default_runs + flag_runs
    runs = list(main_runs)
    runs.append(race_phase(dev, card))
    torch.cuda.empty_cache()
    probe_launches, probe_rows = probes_phase(dev, card)
    runs.append(probe_launches)

    def total(which):
        return {k: sum(r.get(k, 0) for r in which) for k in runs[0]}

    launches, launches_main, launches_default = total(runs), total(main_runs), total(default_runs)
    pallas_bwd = "ape_tpu/ops/msda_window_pallas_bwd.py"
    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    sources = {"msda_fwd": ("msda_fwd.cu", "ape_tpu/ops/msda_window_pallas_v2.py:795", "msda_encoder"),
               "msda_fwd_window": ("msda_fwd.cu", "ape_tpu/ops/msda_window_pallas_v2.py:795",
                                   "msda_window"),
               "msda_bwd": ("msda_bwd.cu", f"{pallas_bwd}:961", "msda_bwd_encoder"),
               "msda_bwd_offatt": ("msda_bwd_split.cu", f"{pallas_bwd}:283", "msda_bwd_offatt"),
               "msda_bwd_value": ("msda_bwd_split.cu", f"{pallas_bwd}:487", "msda_bwd_value"),
               "attn_fwd": ("attn_fwd.cu", "ape_tpu/modeling/backbone/eva_vit.py:136", "attention"),
               "attn_bwd_dkv": ("attn_bwd.cu", f"{flash}:941", "attn_bwd_dkv"),
               "attn_bwd_dq": ("attn_bwd.cu", f"{flash}:1287", "attn_bwd_dq"),
               "msda_fwd_pair": ("msda_fwd_pair.cu", "experiments/msda_window_pallas_v1.py:318",
                                 "msda_fwd_pair"),
               "msda_fwd_rows": ("msda_fwd_rows.cu", "experiments/msda_window_pallas_v3.py:292",
                                 "msda_fwd_rows"),
               "msda_fwd_qlevel": ("msda_fwd_qlevel.cu", "experiments/msda_window_pallas_v5.py:324",
                                   "msda_fwd_qlevel"),
               "msda_fwd_dense": ("msda_fwd_dense.cu", "experiments/msda_window_pallas_v6.py:394",
                                  "msda_fwd_dense"),
               "msda_pair_probe": ("msda_pair_probe.cu", "experiments/pair_probe.py:304", None),
               "attn_fwd_tiles": ("attn_fwd_tiles.cu", "experiments/backbone_fix_probe.py:26", None)}
    unlaunched = [name for name in sources if not launches[name]]
    if unlaunched:
        fail(f"kernels no path launched: {unlaunched}")
    kernels = []
    for name, (source, replaces, case) in sources.items():
        source = f"ape_tpu_torch/csrc/{source}"
        rec = kern[(case, "bfloat16")] if case else probe_rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "launches_main": launches_main[name],
                        "launches_default": launches_default[name],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                        **({"general_ms": rec["general_ms"]} if "general_ms" in rec else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
