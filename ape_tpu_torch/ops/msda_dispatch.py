"""MSDA entry points: the CUDA gather kernel and its backward for CUDA
tensors, the plain version and its gradient (``ops/msda.py``) for CPU
tensors.

Counterpart of ``ape_tpu/ops/msda_dispatch.py`` (encoder, window mode) and
``ape_tpu/ops/msda_decoder.py`` (decoder, exact mode). Both modes reduce to
one exact bilinear gather, ``csrc/msda_fwd.cu``:

  * window mode takes offsets in value-level pixels around each query's grid
    center (queries are the pyramid grid itself) and clips them to
    ``[-radius, radius]`` before the gather, as ``_exact_equiv`` does. With
    no gradient to carry (serving, ``torch.inference_mode``), K1's window
    entry (``msda_fwd_window_cuda``) clips inside the kernel, as the TPU
    kernel does; under autograd the clip stays in torch
    (``window_locations``) and K1 takes the locations (``window_route``);
  * exact mode takes normalized sampling locations as they are.

K1 has two bodies at head width 32, which every MSDA layer of APE has: the
D = 32 body (8 lanes an item), which launches take there, and the general
one (a warp an item, every head width), equal bit for bit; ``body`` selects
either, so that the card can compare them. K3 and K4 (the split backward's
d_loc and d_att, and d_value) have the same two bodies, chosen the same
way, and K8 (``FUSED``) and K9 (``V6``) a D = 32 body and a general one
(``msda_window_forms.BODIES``; K9's D = 32 body takes bf16 only).

Locations stay f32 in both modes. (The JAX exact path rounds them to the
value dtype first, ``loc.astype(value.dtype)``; at bf16 that moves a tap by up
to 0.25 px on a 128-wide level.)

Gradients: ``_MSDAFunction`` pairs the forward with ``csrc/msda_bwd.cu`` (K2,
the merged backward ``ape_tpu/ops/msda_window_pallas_bwd.py`` runs on the
TPU), which returns d_value, d_loc and d_att for both modes. With
``BWD_MERGED`` false (``APE_MSDA_BWD_MERGED=0``, as that file reads it), the
encoder's window mode takes the split form instead, ``csrc/msda_bwd_split.cu``:
K3 for d_loc and d_att, K4 for d_value. The flag is read at each backward, so
one process can run both forms. The decoder stays on K2 (JAX's decoder
backward never reaches K3 or K4). The window clip and the division by the
level size stay in torch (``window_locations``), so autograd carries their
chain rule. JAX's dense-matmul decoder backward (``_dvalue_dense``) is not
ported: the decoder's backward runs on K2 too.

Operators. The forward (K1, its window entry, the forms below) and the
backward (K2, or K3 + K4) are PyTorch dispatcher operators, ``ape::msda_fwd``,
``ape::msda_fwd_window`` and ``ape::msda_bwd``, on the card and on the CPU
(where they run the plain versions, ``ops/msda.py``), for two reasons:
``FlopCounterMode`` counts each by a registered formula (``msda_flops``),
which it cannot do for a ``ctypes`` launch or a gather; and the encoder's
recompute can keep the forward's output (JAX's ``msda_out`` remat policy,
``REMAT_POLICY``): ``remat_context_fn`` gives ``torch.utils.checkpoint`` a
selective-checkpoint policy that saves the output of every window-mode
``ape::msda_fwd`` call, the forward's own tensor in its dtype, and hands it
to the recompute in place of a second launch. The backward then runs K2 (or
K3 + K4) on the recomputed locations with the incoming gradient. The exact
mode (the decoder) saves nothing.

Forms of the encoder's forward. JAX selects two other window-MSDA forwards
with environment variables, and so does the port, with module flags of the
same names, read at each call so that one process can run every form:

  * ``FUSED`` (``APE_MSDA_FUSED`` != "0"): K8, ``csrc/msda_fwd_qlevel.cu``,
    every value level of a query level in one launch;
  * ``V6`` (``APE_MSDA_V6`` != "0"), taken only with 8 heads: K9,
    ``csrc/msda_fwd_dense.cu``, on the query levels whose width is a
    multiple of 128, the narrower ones on K1.

``FUSED`` goes first, as in JAX (``ape_tpu/ops/msda_dispatch.py:49-60``).
Only the encoder's window mode takes them; the decoder's exact mode stays on
K1. Under autograd each form's forward pairs with the backward above (K2,
or K3 + K4), as JAX's ``custom_vjp`` pairs any of its forwards with one
backward. The forms' plans and kernels are in ``msda_window_forms.py``; on
CPU tensors every form is the plain version.
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)
from torch.utils.flop_counter import register_flop_formula

from ape_tpu_torch.ops import _build, msda_window_forms
from ape_tpu_torch.ops.msda import level_start_index, ms_deform_attn, ms_deform_attn_backward
from ape_tpu_torch.ops.tables import device_table, shapes_key

# The encoder's window-MSDA backward: merged (K2) unless APE_MSDA_BWD_MERGED=0
# selects the split kernels (K3 + K4).
BWD_MERGED = os.environ.get("APE_MSDA_BWD_MERGED", "1") != "0"
# The encoder's window-MSDA forward: K1 unless APE_MSDA_FUSED (K8) or, with 8
# heads, APE_MSDA_V6 (K9 + K1) selects another form.
FUSED = os.environ.get("APE_MSDA_FUSED", "0") != "0"
V6 = os.environ.get("APE_MSDA_V6", "0") != "0"
# The encoder layers' recompute (``use_act_checkpoint``), as JAX's
# ``_remat_policy`` reads APE_REMAT_POLICY: "msda" (the default, any value
# but "full") keeps each layer's window-MSDA output from the forward, so the
# recompute reruns only the projections and the locations; "full"
# recomputes everything. Read at each layer's call (``remat_context_fn``).
REMAT_POLICY = "full" if os.environ.get("APE_REMAT_POLICY", "msda") == "full" else "msda"


# K1's two bodies (csrc/msda_fwd.cu), by the entries' ``body`` argument.
BODIES = {"general": 0, "d32": 1}


def fwd_body(head_dim: int) -> str:
    """K1's body for a launch: "d32" at head width 32, else "general". No
    launch of few items needs the general body: on an H100 80GB HBM3 at 700 W
    the D = 32 body took less device time at every item count measured, from
    400 items (0.0095 against 0.019 ms) through the decoder's 4,800 and 7,200
    (0.012-0.013 against 0.026-0.035) to the encoder's 174,592 and more
    (3.0-3.6x less); ``chip_smoke.py``'s kernels phase times both (PERF.md)."""
    return "d32" if head_dim == 32 else "general"


def window_route(form: str, device_type: str, needs_grad: bool) -> str:
    """How the encoder's window op runs: "window", K1's window entry with the
    clip inside, for the "gather" form on a card when no gradient is needed;
    else "locations", ``window_locations`` in torch (whose autograd carries
    the clip's chain rule), then K1, another form, or on the CPU the plain
    version."""
    if form == "gather" and device_type == "cuda" and not needs_grad:
        return "window"
    return "locations"


def window_form(heads: int) -> str:
    """The form the encoder's window forward takes on a card now: "qlevel"
    (K8) under FUSED, else "dense" (K9) under V6 with 8 heads, else
    "gather" (K1)."""
    if FUSED:
        return "qlevel"
    if V6 and heads == 8:
        return "dense"
    return "gather"


def grid_centers(spatial_shapes: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """Normalized (x, y) centers of every cell of the pyramid grid: (S, 2) f32
    (a cached table: read-only)."""
    return _grid_centers(shapes_key(spatial_shapes), torch.device(device))


@device_table
def _grid_centers(spatial_shapes, device) -> torch.Tensor:
    pieces = []
    for hq, wq in spatial_shapes:
        yy, xx = torch.meshgrid(
            torch.arange(hq, dtype=torch.float32, device=device),
            torch.arange(wq, dtype=torch.float32, device=device),
            indexing="ij",
        )
        pieces.append(torch.stack([(xx.reshape(-1) + 0.5) / wq, (yy.reshape(-1) + 0.5) / hq], -1))
    return torch.cat(pieces, 0)


def level_sizes(spatial_shapes: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """(L, 2) f32 level sizes as (W, H), the normalizer of (x, y) offsets (a
    cached table: read-only)."""
    return _level_sizes(shapes_key(spatial_shapes), torch.device(device))


@device_table
def _level_sizes(spatial_shapes, device) -> torch.Tensor:
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32, device=device)


@device_table
def _level_tables(spatial_shapes, device):
    """The kernels' int64 level shapes (L, 2) and start offsets (L,)."""
    starts, _ = level_start_index(spatial_shapes)
    return (torch.tensor(spatial_shapes, dtype=torch.int64, device=device),
            torch.tensor(starts, dtype=torch.int64, device=device))


def window_locations(
    spatial_shapes: Sequence[Tuple[int, int]], pixel_offsets: torch.Tensor, radius: float,
    first_query: int = 0,
) -> torch.Tensor:
    """f32 sampling locations ``center + clip(off, -R, R) / size``: (B, Q, H,
    L, P, 2), for the Q queries of the pyramid grid from ``first_query`` on."""
    centers = grid_centers(spatial_shapes, pixel_offsets.device)
    centers = centers[first_query:first_query + pixel_offsets.shape[1]]
    norm = level_sizes(spatial_shapes, pixel_offsets.device)
    off = pixel_offsets.float().clamp(-radius, radius)
    return centers[None, :, None, None, None, :] + off / norm[None, None, None, :, None, :]


def _check_inputs(name, value, spatial_shapes, loc, att):
    """Validate the kernels' inputs; returns the sizes and the level tables
    as int64 tensors on the value's device."""
    return _check_sampling(name, tuple(value.shape), value.dtype, spatial_shapes, loc, att,
                           (value, loc, att))


def _check_sampling(name, value_shape, value_dtype, spatial_shapes, loc, att, tensors):
    """``_check_inputs`` for a value of this shape and dtype, which the
    d_value kernel never reads; ``tensors`` are the ones the kernel takes."""
    b, s, h, d = value_shape
    if value_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 value, got {value_dtype}")
    if loc.dtype != torch.float32:
        raise TypeError(f"{name} takes f32 locations, got {loc.dtype}")
    if att.dtype not in (value_dtype, torch.float32):
        raise TypeError(f"{name} takes attention weights in {value_dtype} or f32, got {att.dtype}")
    if loc.dim() != 6 or loc.shape[-1] != 2 or loc.shape[0] != b or loc.shape[2] != h:
        raise ValueError(f"locations {tuple(loc.shape)} do not match value {value_shape}")
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    if tuple(att.shape) != (b, q, h, l, p):
        raise ValueError(f"attention weights {tuple(att.shape)} != {(b, q, h, l, p)}")
    _, total = level_start_index(spatial_shapes)
    if total != s or len(spatial_shapes) != l:
        raise ValueError(f"value length {s} / {l} levels do not match {spatial_shapes}")
    device = tensors[0].device
    for t in tensors:
        if t.device != device or not t.is_cuda:
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    return (b, s, q, h, d, l, p), _level_tables(shapes_key(spatial_shapes), device)


def _check_grad(name, grad_out, value_dtype, b, q, h, d, device):
    if grad_out.dtype != value_dtype or tuple(grad_out.shape) != (b, q, h * d):
        raise ValueError(f"{name}: grad {grad_out.dtype} {tuple(grad_out.shape)} does not match "
                         f"value {value_dtype} and {(b, q, h * d)}")
    if not grad_out.is_contiguous() or grad_out.device != device:
        raise ValueError(f"{name} takes a contiguous grad on the value's device")


def _fwd_out(name, sizes, value, loc, body):
    """K1's output buffer and body code (``BODIES``) for a launch: ``body``
    None picks by ``fwd_body``. At head width 32 the D = 32 body reads 4
    channels a lane in one load, so value, loc and out must start 16-byte
    aligned."""
    b, _, q, h, d, _, _ = sizes
    body = fwd_body(d) if body is None else body
    if body not in BODIES or (body == "d32" and d != 32):
        raise ValueError(f"{name}: no body {body!r} at head width {d}")
    out = torch.empty(b, q, h * d, dtype=value.dtype, device=value.device)
    if d == 32 and any(t.data_ptr() % 16 for t in (value, loc, out)):
        raise ValueError(f"{name} at head width 32 takes value, locations and out at "
                         "16-byte aligned addresses")
    return out, BODIES[body]


def msda_fwd_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    att: torch.Tensor,
    body: str | None = None,
) -> torch.Tensor:
    """Launch ``csrc/msda_fwd.cu``. Shapes and layouts as ``ops.msda.ms_deform_attn``;
    ``body`` ("d32" or "general") overrides ``fwd_body``."""
    sizes, (shapes_t, starts_t) = _check_inputs("msda_fwd", value, spatial_shapes, loc, att)
    out, code = _fwd_out("msda_fwd", sizes, value, loc, body)
    err = _build.library().ape_msda_fwd(
        value.data_ptr(), loc.data_ptr(), att.data_ptr(), shapes_t.data_ptr(),
        starts_t.data_ptr(), out.data_ptr(), *sizes,
        int(value.dtype == torch.bfloat16), int(att.dtype == torch.float32), code,
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    _build.check(err, "msda_fwd")
    _build.LAUNCHES["msda_fwd"] += 1
    return out


def msda_fwd_window_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    pixel_offsets: torch.Tensor,
    att: torch.Tensor,
    radius: float,
    first_query: int = 0,
    body: str | None = None,
) -> torch.Tensor:
    """Launch K1's window entry (``csrc/msda_fwd.cu``): the window op of the
    Q queries of the pyramid grid from ``first_query`` on, with the clip
    inside the kernel; equal bit for bit to ``msda_fwd_cuda`` on
    ``window_locations(spatial_shapes, pixel_offsets, radius, first_query)``.
    pixel_offsets (B, Q, H, L, P, 2) f32; the rest as ``msda_fwd_cuda``."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    sizes, (shapes_t, starts_t) = _check_inputs("msda_fwd_window", value, spatial_shapes,
                                                pixel_offsets, att)
    _, s, q = sizes[:3]
    if not 0 <= first_query <= s - q:
        raise ValueError(f"msda_fwd_window: queries {first_query} .. {first_query + q - 1} "
                         f"outside the grid's {s}")
    out, code = _fwd_out("msda_fwd_window", sizes, value, pixel_offsets, body)
    centers = grid_centers(spatial_shapes, value.device)
    norm = level_sizes(spatial_shapes, value.device)
    err = _build.library().ape_msda_fwd_window(
        value.data_ptr(), pixel_offsets.data_ptr(), att.data_ptr(), shapes_t.data_ptr(),
        starts_t.data_ptr(), centers.data_ptr(), norm.data_ptr(), float(radius), first_query,
        out.data_ptr(), *sizes,
        int(value.dtype == torch.bfloat16), int(att.dtype == torch.float32), code,
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    _build.check(err, "msda_fwd_window")
    _build.LAUNCHES["msda_fwd_window"] += 1
    return out


def msda_bwd_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    att: torch.Tensor,
    grad_out: torch.Tensor,
):
    """Launch ``csrc/msda_bwd.cu``: (d_value, d_loc, d_att) of ``msda_fwd_cuda``
    for the upstream gradient grad_out (B, Q, H * D), in the dtypes of value,
    loc (f32) and att. d_value is summed by f32 atomics, then cast. At D = 32
    the kernel reads 4 channels a lane in one load, so value, grad_out and
    loc must start 16-byte aligned."""
    sizes, (shapes_t, starts_t) = _check_inputs("msda_bwd", value, spatial_shapes, loc, att)
    b, s, q, h, d, _, _ = sizes
    _check_grad("msda_bwd", grad_out, value.dtype, b, q, h, d, value.device)
    if d == 32 and any(t.data_ptr() % 16 for t in (value, grad_out, loc)):
        raise ValueError("msda_bwd at head width 32 takes value, grad and locations at "
                         "16-byte aligned addresses")
    d_value = torch.zeros(b, s, h, d, dtype=torch.float32, device=value.device)
    d_loc = torch.empty(loc.shape, dtype=torch.float32, device=value.device)
    d_att = torch.empty(att.shape, dtype=torch.float32, device=value.device)
    err = _build.library().ape_msda_bwd(
        value.data_ptr(), loc.data_ptr(), att.data_ptr(), shapes_t.data_ptr(),
        starts_t.data_ptr(), grad_out.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(),
        d_att.data_ptr(), *sizes,
        int(value.dtype == torch.bfloat16), int(att.dtype == torch.float32),
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    _build.check(err, "msda_bwd")
    _build.LAUNCHES["msda_bwd"] += 1
    return d_value.to(value.dtype), d_loc, d_att.to(att.dtype)


def msda_bwd_offatt_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    att: torch.Tensor,
    grad_out: torch.Tensor,
    body: str | None = None,
):
    """Launch K3 of ``csrc/msda_bwd_split.cu``: (d_loc, d_att) of
    ``msda_fwd_cuda`` for grad_out (B, Q, H * D), d_loc in f32 and d_att in
    att's dtype. No atomics: deterministic. Two bodies, as K1's: ``body``
    ("d32" or "general") overrides ``fwd_body``; the D = 32 body's d_loc and
    d_att equal K2's bit for bit (d_att rounded once to att's dtype), and it
    takes value, loc and grad_out at 16-byte aligned addresses."""
    sizes, (shapes_t, starts_t) = _check_inputs("msda_bwd_offatt", value, spatial_shapes, loc, att)
    b, _, q, h, d, _, _ = sizes
    _check_grad("msda_bwd_offatt", grad_out, value.dtype, b, q, h, d, value.device)
    body = fwd_body(d) if body is None else body
    if body not in BODIES or (body == "d32" and d != 32):
        raise ValueError(f"msda_bwd_offatt: no body {body!r} at head width {d}")
    if body == "d32" and any(t.data_ptr() % 16 for t in (value, grad_out, loc)):
        raise ValueError("msda_bwd_offatt's D = 32 body takes value, grad and locations at "
                         "16-byte aligned addresses")
    d_loc = torch.empty(loc.shape, dtype=torch.float32, device=value.device)
    d_att = torch.empty(att.shape, dtype=att.dtype, device=value.device)
    err = _build.library().ape_msda_bwd_offatt(
        value.data_ptr(), loc.data_ptr(), att.data_ptr(), shapes_t.data_ptr(),
        starts_t.data_ptr(), grad_out.data_ptr(), d_loc.data_ptr(), d_att.data_ptr(), *sizes,
        int(value.dtype == torch.bfloat16), int(att.dtype == torch.float32), BODIES[body],
        torch.cuda.current_stream(value.device).cuda_stream,
    )
    _build.check(err, "msda_bwd_offatt")
    _build.LAUNCHES["msda_bwd_offatt"] += 1
    return d_loc, d_att


def msda_bwd_value_cuda(
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    att: torch.Tensor,
    grad_out: torch.Tensor,
    body: str | None = None,
) -> torch.Tensor:
    """Launch K4 of ``csrc/msda_bwd_split.cu``: d_value (B, S, H, D) of
    ``msda_fwd_cuda`` for grad_out (B, Q, H * D), in grad_out's dtype (the
    value's). It reads no value. Summed by f32 atomics, then cast. Two
    bodies, as K3's: ``body`` ("d32" or "general") overrides ``fwd_body``;
    the D = 32 body adds K2's addends (differing from K2 only by the order of
    the atomics), and takes loc and grad_out at 16-byte aligned addresses."""
    b, _, h = loc.shape[:3]
    d = grad_out.shape[-1] // h
    _, total = level_start_index(spatial_shapes)
    sizes, (shapes_t, starts_t) = _check_sampling(
        "msda_bwd_value", (b, total, h, d), grad_out.dtype, spatial_shapes, loc, att,
        (grad_out, loc, att))
    _, s, q, _, _, _, _ = sizes
    _check_grad("msda_bwd_value", grad_out, grad_out.dtype, b, q, h, d, grad_out.device)
    body = fwd_body(d) if body is None else body
    if body not in BODIES or (body == "d32" and d != 32):
        raise ValueError(f"msda_bwd_value: no body {body!r} at head width {d}")
    if body == "d32" and any(t.data_ptr() % 16 for t in (grad_out, loc)):
        raise ValueError("msda_bwd_value's D = 32 body takes grad and locations at 16-byte "
                         "aligned addresses")
    d_value = torch.zeros(b, s, h, d, dtype=torch.float32, device=grad_out.device)
    err = _build.library().ape_msda_bwd_value(
        loc.data_ptr(), att.data_ptr(), shapes_t.data_ptr(), starts_t.data_ptr(),
        grad_out.data_ptr(), d_value.data_ptr(), *sizes,
        int(grad_out.dtype == torch.bfloat16), int(att.dtype == torch.float32), BODIES[body],
        torch.cuda.current_stream(grad_out.device).cuda_stream,
    )
    _build.check(err, "msda_bwd_value")
    _build.LAUNCHES["msda_bwd_value"] += 1
    return d_value.to(grad_out.dtype)


# f32 flops per (sample, channel) that the MSDA operators' FLOP formulas
# count: the forward's 4 corner FMAs and the attention weight's; the
# backward's three dot products (d_att, d_x, d_y) and 4 scatters (K2, or K3's
# 22 and K4's 4).
SAMPLE_FLOPS = {"fwd": 10, "bwd": 26}


def msda_flops(kind: str, value_shape, att_shape) -> int:
    """FLOPs of an MSDA operator of ``kind`` ("fwd" or "bwd") on a value (B,
    S, H, D) and attention weights (B, Q, H, L, P): ``SAMPLE_FLOPS[kind]``
    per sample and channel, from the shapes alone, so that the count is the
    same on the card and on the CPU, whatever implements the operator. The
    window entry's clip and the locations' arithmetic are elementwise work,
    which ``FlopCounterMode`` counts on neither device."""
    return SAMPLE_FLOPS[kind] * math.prod(att_shape) * int(value_shape[-1])


def _shapes_arg(spatial_shapes) -> List[int]:
    return [int(x) for hw in spatial_shapes for x in hw]


def _shapes_of(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2))


# The MSDA forward and backward as operators of PyTorch's dispatcher, so that
# FlopCounterMode counts them by ``msda_flops`` and the encoder's recompute
# policy (``remat_context_fn``) can keep the forward's output: the CUDA
# kernels on the card, the plain versions (``ops/msda.py``) on the CPU.
@torch.library.custom_op("ape::msda_fwd", mutates_args=())
def msda_fwd_op(value: torch.Tensor, loc: torch.Tensor, att: torch.Tensor, shapes: List[int],
                form: str, pixel_offsets: Optional[torch.Tensor], radius: float) -> torch.Tensor:
    """The MSDA forward at the f32 locations ``loc``: (B, Q, H * D). form:
    "exact" for the decoder, else the form of the encoder's window op
    (``window_form``): K1 for "exact" and "gather", K8 or K9 + K1 from the
    clipped ``pixel_offsets`` for "qlevel" and "dense"; the plain version on
    CPU tensors. shapes: the levels' (H, W), flattened."""
    spatial_shapes = _shapes_of(shapes)
    if not value.is_cuda:
        return ms_deform_attn(value, spatial_shapes, loc, att)
    if form in ("exact", "gather"):
        return msda_fwd_cuda(value, spatial_shapes, loc, att)
    return msda_window_forms.window_form_cuda(form, value, spatial_shapes, pixel_offsets, att,
                                              radius)


@msda_fwd_op.register_fake
def _(value, loc, att, shapes, form, pixel_offsets, radius):
    return value.new_empty(value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])


@torch.library.custom_op("ape::msda_fwd_window", mutates_args=())
def msda_fwd_window_op(value: torch.Tensor, pixel_offsets: torch.Tensor, att: torch.Tensor,
                       shapes: List[int], radius: float) -> torch.Tensor:
    """K1's window entry (``msda_fwd_window_cuda``) as an operator."""
    return msda_fwd_window_cuda(value, _shapes_of(shapes), pixel_offsets, att, radius)


@msda_fwd_window_op.register_fake
def _(value, pixel_offsets, att, shapes, radius):
    return value.new_empty(value.shape[0], pixel_offsets.shape[1],
                           value.shape[2] * value.shape[3])


@torch.library.custom_op("ape::msda_bwd", mutates_args=())
def msda_bwd_op(value: torch.Tensor, loc: torch.Tensor, att: torch.Tensor,
                grad_out: torch.Tensor, shapes: List[int],
                split: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_value, d_loc, d_att) of ``msda_fwd_op`` for grad_out (B, Q, H * D):
    K2, or with ``split`` K3 + K4; the plain backward on CPU tensors."""
    spatial_shapes = _shapes_of(shapes)
    if not value.is_cuda:
        return ms_deform_attn_backward(value, spatial_shapes, loc, att, grad_out)
    if split:
        d_loc, d_att = msda_bwd_offatt_cuda(value, spatial_shapes, loc, att, grad_out)
        return msda_bwd_value_cuda(spatial_shapes, loc, att, grad_out), d_loc, d_att
    return msda_bwd_cuda(value, spatial_shapes, loc, att, grad_out)


@msda_bwd_op.register_fake
def _(value, loc, att, grad_out, shapes, split):
    return (torch.empty_like(value), torch.empty_like(loc, dtype=torch.float32),
            torch.empty_like(att))


@register_flop_formula([torch.ops.ape.msda_fwd, torch.ops.ape.msda_fwd_window])
def _msda_fwd_flops(value_shape, loc_shape, att_shape, *args, out_shape=None, **kwargs):
    return msda_flops("fwd", value_shape, att_shape)


@register_flop_formula(torch.ops.ape.msda_bwd)
def _msda_bwd_flops(value_shape, loc_shape, att_shape, *args, out_shape=None, **kwargs):
    return msda_flops("bwd", value_shape, att_shape)


class _MSDAFunction(torch.autograd.Function):
    """The forward operator (K1, or for the encoder's window mode another
    form: ``window`` is (form, pixel offsets, radius), ``window_form``), then
    the backward operator: K2, or for the window mode under ``BWD_MERGED =
    False`` K3 + K4; on CPU tensors the plain versions. Every form's backward
    reads the locations, whose gradient carries the clip's."""

    @staticmethod
    def forward(ctx, value, loc, att, spatial_shapes, window):
        ctx.spatial_shapes = spatial_shapes
        ctx.window = window is not None
        ctx.save_for_backward(value, loc, att)
        return _forward(value, spatial_shapes, loc, att, window)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, att = ctx.saved_tensors
        d_value, d_loc, d_att = torch.ops.ape.msda_bwd(
            value, loc, att, grad_out.contiguous(), _shapes_arg(ctx.spatial_shapes),
            ctx.window and not BWD_MERGED)
        return d_value, d_loc, d_att, None, None


def _forward(value, spatial_shapes, loc, att, window):
    """The forward operator: the exact mode, or the window form ``window``
    names."""
    form, pixel_offsets, radius = ("exact", None, 0.0) if window is None else window
    return torch.ops.ape.msda_fwd(value, loc, att, _shapes_arg(spatial_shapes), form,
                                  pixel_offsets, float(radius))


def _route(value, spatial_shapes, loc, att, window=None):
    """window: None for the exact mode, else (form, pixel offsets, radius)."""
    if value.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no MSDA implementation for device {value.device}")
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or att.requires_grad):
        return _MSDAFunction.apply(value, loc, att, spatial_shapes, window)
    return _forward(value, spatial_shapes, loc, att, window)


def _save_window_output(ctx, op, *args, **kwargs):
    """The selective recompute's policy: keep the window forward's output."""
    if op is torch.ops.ape.msda_fwd.default and args[4] != "exact":
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_context_fn():
    """``torch.utils.checkpoint``'s ``context_fn`` for an encoder layer's
    recompute under ``REMAT_POLICY``: under "msda" the recompute takes the
    window forward's output that the forward kept, so the backward launches
    no forward kernel; under "full" (``noop_context_fn``) it runs the
    forward again."""
    if REMAT_POLICY == "full":
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts, _save_window_output)


def ms_deform_attn_window(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    pixel_offsets: torch.Tensor,
    attention_weights: torch.Tensor,
    radius: float = 4,
) -> torch.Tensor:
    """Window-clamped MSDA of the encoder: queries are the pyramid grid.

    pixel_offsets (B, Q, H, L, P, 2) are in value-level pixels around each
    query's center, valid-ratio shift included. Returns (B, Q, H * D).
    """
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    form = window_form(value.shape[2]) if value.is_cuda else "gather"
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (value, pixel_offsets, attention_weights))
    if window_route(form, value.device.type, needs_grad) == "window":
        return torch.ops.ape.msda_fwd_window(value, pixel_offsets.float().contiguous(),
                                             attention_weights.contiguous(),
                                             _shapes_arg(spatial_shapes), float(radius))
    loc = window_locations(spatial_shapes, pixel_offsets, radius)
    off = None if form == "gather" else pixel_offsets.detach().float().contiguous()
    return _route(value, spatial_shapes, loc.contiguous(), attention_weights.contiguous(),
                  window=(form, off, radius))


def ms_deform_attn_exact(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Exact MSDA of the decoder at normalized locations. Returns (B, Q, H * D)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    loc = sampling_locations.float().contiguous()
    return _route(value, spatial_shapes, loc, attention_weights.contiguous())
