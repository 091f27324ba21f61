"""MSDA entry points: the CUDA gather kernel and its backward for CUDA
tensors, the plain version (and torch autograd of it) for CPU tensors.

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

import os
from typing import Sequence, Tuple

import torch

from ape_tpu_torch.ops import _build, msda_window_forms
from ape_tpu_torch.ops.msda import level_start_index, ms_deform_attn
from ape_tpu_torch.ops.tables import device_table, shapes_key

# The encoder's window-MSDA backward: merged (K2) unless APE_MSDA_BWD_MERGED=0
# selects the split kernels (K3 + K4).
BWD_MERGED = os.environ.get("APE_MSDA_BWD_MERGED", "1") != "0"
# The encoder's window-MSDA forward: K1 unless APE_MSDA_FUSED (K8) or, with 8
# heads, APE_MSDA_V6 (K9 + K1) selects another form.
FUSED = os.environ.get("APE_MSDA_FUSED", "0") != "0"
V6 = os.environ.get("APE_MSDA_V6", "0") != "0"


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


class _MSDAFunction(torch.autograd.Function):
    """msda_fwd.cu forward, or for the encoder's window mode another form
    (``window``: (form, pixel offsets, radius), ``window_form``);
    msda_bwd.cu backward, or for the window mode under ``BWD_MERGED = False``
    msda_bwd_split.cu (CUDA tensors only). Every form's backward reads the
    locations, whose gradient carries the clip's."""

    @staticmethod
    def forward(ctx, value, loc, att, spatial_shapes, window):
        ctx.spatial_shapes = spatial_shapes
        ctx.window = window is not None
        ctx.save_for_backward(value, loc, att)
        return _forward(value, spatial_shapes, loc, att, window)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, att = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        if ctx.window and not BWD_MERGED:
            d_loc, d_att = msda_bwd_offatt_cuda(value, ctx.spatial_shapes, loc, att, grad_out)
            d_value = msda_bwd_value_cuda(ctx.spatial_shapes, loc, att, grad_out)
        else:
            d_value, d_loc, d_att = msda_bwd_cuda(value, ctx.spatial_shapes, loc, att, grad_out)
        return d_value, d_loc, d_att, None, None


def _forward(value, spatial_shapes, loc, att, window):
    """The forward kernels: K1, or the window form ``window`` names."""
    if window is None or window[0] == "gather":
        return msda_fwd_cuda(value, spatial_shapes, loc, att)
    form, pixel_offsets, radius = window
    return msda_window_forms.window_form_cuda(form, value, spatial_shapes, pixel_offsets, att,
                                              radius)


def _route(value, spatial_shapes, loc, att, window=None):
    """window: None for the exact mode, else (form, pixel offsets, radius)."""
    if value.is_cuda:
        if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                        or att.requires_grad):
            return _MSDAFunction.apply(value, loc, att, spatial_shapes, window)
        return _forward(value, spatial_shapes, loc, att, window)
    if value.device.type == "cpu":
        return ms_deform_attn(value, spatial_shapes, loc, att)
    raise ValueError(f"no MSDA implementation for device {value.device}")


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
        return msda_fwd_window_cuda(value, spatial_shapes, pixel_offsets.float().contiguous(),
                                    attention_weights.contiguous(), radius)
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
