"""The encoder's window-MSDA forward forms beside K1: plans, plain versions
and the wrappers of their CUDA kernels.

Counterparts of the JAX repository's window-MSDA layout studies. Each form
computes K1's function (``msda_dispatch.ms_deform_attn_window``: window-
clamped MSDA where the queries are the pyramid grid) from pixel offsets,
with the clip inside the kernel:

  * ``pair``   (K6, ``experiments/msda_window_pallas_v1.py``): one launch of
    ``csrc/msda_fwd_pair.cu`` per (query level, value level) pair, 25 a
    layer on five levels, added into one f32 buffer. At head width 32 its
    D = 32 body: one TMA box of a same-or-coarser level, a finer one read
    from device memory;
  * ``rows``   (K7, ``experiments/msda_window_pallas_v3.py``): per query
    level its finer pairs on K6, then one launch of ``csrc/msda_fwd_rows.cu``
    over its same-or-coarser value levels, which continues their sums. At
    head width 32 its D = 32 body: the levels in a loop inside the block,
    their boxes through a ring of two shared-memory slots filled by TMA;
  * ``qlevel`` (K8, ``experiments/msda_window_pallas_v5.py``, JAX's
    ``APE_MSDA_FUSED``): per query level one launch of
    ``csrc/msda_fwd_qlevel.cu`` over every value level, or one per group of
    levels where a block's shared memory cannot hold them all. At head width
    32 its D = 32 body (``BODIES``): TMA boxes of the same-or-coarser
    levels, the finer ones read from device memory; at other widths its
    general body, which stages a finer level's windows per query, as K6's
    and K7's general bodies do;
  * ``dense``  (K9, ``experiments/msda_window_pallas_v6.py``, JAX's
    ``APE_MSDA_V6``): ``csrc/msda_fwd_dense.cu`` on each query level whose
    width is a multiple of 128, one K1 launch over each run of contiguous
    narrower query levels. At head width 32 with a bf16 value its D = 32
    body (``dense_body``): the tile's weight matrix W (K1's corner weights,
    f32) against each staged box on the tensor cores, W split into two bf16
    halves; the finer levels read from device memory. Else its general
    body, a dense tap map per query contracted by FMAs;
  * ``gather`` (K1, ``csrc/msda_fwd.cu``): the default, for comparison.

The D = 32 bodies of K6, K7 and K8 add each query's samples in K1's order
and equal K1's window entry bit for bit.

``plan_layer`` makes each form's launches for a pyramid in plain Python, so
the tests check the routing with no card and ``chip_smoke.py`` knows the
launches a forward must count. On CPU tensors every form is the plain
version: ``window_pair_plain`` for one pair (the counterpart of JAX's
``xla_pair``), ``window_qlevel_plain`` for a query level (the sum of its
pairs), and the whole op through ``window_locations`` and the exact gather.
For a CUDA tensor each form launches its kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ape_tpu_torch.ops import _build
from ape_tpu_torch.ops.msda import level_start_index, ms_deform_attn, sample_level

FORMS = ("gather", "pair", "rows", "qlevel", "dense")
SMEM_LIMIT = 232448  # dynamic shared memory one block may take on an H100 (227 KB)
WARPS = 8            # csrc/msda_window.cuh: kWarps
MAX_POINTS = 32      # kMaxPoints
MAX_LEVELS = 16      # msda_sample.cuh: kMaxLevels
# Query tiles, largest first, at most WARPS * 16 queries (kQueriesPerWarp).
TILES = ((8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
DENSE_WIDTH = 128    # K9 takes the query levels whose width is a multiple of this
# A launch's output: in the value's dtype, the f32 sums stored, or the sums
# continued from the f32 partial an earlier launch of the query level stored
# (loaded into the accumulators, then stored).
OUT_MODES = {"value": 0, "store": 1, "continue": 2}
# The bodies of K6-K9: "d32" (head width 32 only: msda_fwd_pair_kernel_d32,
# msda_fwd_rows_kernel_d32, msda_fwd_qlevel_kernel_d32 and, for a bf16 value
# only, msda_fwd_dense_kernel_d32) and "general" (every head width up to 32).
BODIES = ("d32", "general")
D32_HEADER_BYTES = 256  # the D = 32 bodies' barriers and box corners, before their boxes
TMA_ALIGN = 128         # bytes: a TMA box's shared-memory address
# The tiles of K6's, K7's and K8's D = 32 bodies: at most 64 queries, one
# pass of K7's and K8's 16 warps of 4 queries (csrc/msda_window.cuh:
# kD32TileQueries) and of K6's 8 warps of 8
D32_TILES = tuple(t for t in TILES if t[0] * t[1] <= 64)
# What a launch of the D = 32 body does: the op ("whole"), or to time its
# parts, only the staged levels' samples, only the finer levels', or the
# whole op with the boxes staged by cp.async instead of TMA (csrc/
# msda_fwd_qlevel.cu: Variant). Only "whole" gives the op's output.
D32_VARIANTS = {"whole": 0, "boxes_only": 1, "finer_only": 2, "cp_async": 3}
# K9's D = 32 body: tiles of at most 32 queries, two m16 blocks of its
# mma.sync products (csrc/msda_fwd_dense.cu: kDenseRows); its shared memory:
# the f32 out tile (32 rows of 40 floats), W (32 rows of a stride of 8 mod 32
# floats), one box (64 swizzled bytes a pixel, padded to 16 pixels) at a
# 1024-byte aligned offset, the box's mbarrier (16 bytes).
DENSE_D32_TILES = tuple(t for t in TILES if t[0] * t[1] <= 32)
DENSE_D32_ROWS, DENSE_D32_OUT_ROW, DENSE_D32_BOX_ROW = 32, 40, 64
DENSE_D32_BOX_ALIGN, DENSE_D32_BARRIER = 1024, 16
# What a launch of K9's D = 32 body does (csrc/msda_fwd_dense.cu:
# DenseVariant): the op ("whole"), or to time its parts, the box levels
# alone, the finer levels alone, the box levels without the products, or
# only their staging. Only "whole" gives the op's output.
DENSE_D32_VARIANTS = {"whole": 0, "boxes_only": 1, "finer_only": 2, "no_mma": 3,
                      "staging_only": 4}

Shapes = Tuple[Tuple[int, int], ...]


def window_taps(radius: float) -> int:
    """Pixels per axis that hold a query's samples: 2 ceil(R) + 3."""
    return 2 * math.ceil(radius) + 3


def finer(query_shape, value_shape) -> bool:
    """Whether the value level is finer than the query level on either axis."""
    return value_shape[0] > query_shape[0] or value_shape[1] > query_shape[1]


def box_extent(t: int, nq: int, nv: int, win: int) -> int:
    """Bound on the pixels, along one axis, that a tile of t queries (of nq)
    reads on a value level of nv: the spread of its windows' bases, at most
    floor((t - 1) nv / nq) + 1, plus one window."""
    return (t - 1) * nv // nq + 1 + win


@dataclass(frozen=True)
class Launch:
    """One kernel launch of a form: the kernel, its query rows (a query level,
    or for K1 a run of them) and value levels, its tile, the staged box of each
    value level ((0, 0) for a finer level), shared memory, output mode, and
    body ("d32" or "general", ``BODIES``; K1 takes its own by the head
    width)."""

    kernel: str
    query_levels: Tuple[int, ...]
    value_levels: Tuple[int, ...]
    tile: Tuple[int, int] = (1, 1)
    boxes: Tuple[Tuple[int, int], ...] = ()
    smem: int = 0
    out_mode: str = "value"
    body: str = "general"


def _d32_layout(shapes: Shapes, lq: int, lvs, tile, esize: int, win: int):
    """``_layout`` of K8's and K6's D = 32 bodies: the header
    (D32_HEADER_BYTES), then each staged box at a TMA_ALIGN-byte aligned
    offset; no query windows (a finer level is read from device memory)."""
    hq, wq = shapes[lq]
    boxes, offsets, total = [], [], D32_HEADER_BYTES
    for lv in lvs:
        if finer(shapes[lq], shapes[lv]):
            boxes.append((0, 0))
            offsets.append(0)
            continue
        hv, wv = shapes[lv]
        box = (box_extent(tile[0], hq, hv, win), box_extent(tile[1], wq, wv, win))
        total = -(-total // TMA_ALIGN) * TMA_ALIGN
        boxes.append(box)
        offsets.append(total // esize)
        total += box[0] * box[1] * 32 * esize
    return tuple(boxes), tuple(offsets), 0, 0, total


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _ring_layout(shapes: Shapes, lq: int, lvs, tile, esize: int, win: int):
    """``_layout`` of K7's D = 32 body: the header, then two slots at
    TMA_ALIGN-byte aligned offsets, each sized for the launch's largest box;
    level j's box goes to slot j mod 2 (csrc/msda_fwd_rows.cu: ring_plan).
    Every level is staged: the rows plan gives K7 no finer level."""
    hq, wq = shapes[lq]
    if any(finer(shapes[lq], shapes[lv]) for lv in lvs):
        raise ValueError(f"msda_fwd_rows: value levels {lvs} hold one finer than {shapes[lq]}")
    boxes = tuple((box_extent(tile[0], hq, shapes[lv][0], win),
                   box_extent(tile[1], wq, shapes[lv][1], win)) for lv in lvs)
    largest = max(h * w for h, w in boxes) * 32 * esize
    slots = (_round_up(D32_HEADER_BYTES, TMA_ALIGN),)
    slots += (slots[0] + _round_up(largest, TMA_ALIGN),)
    offsets = tuple(slots[j % 2] // esize for j in range(len(lvs)))
    return boxes, offsets, 0, 0, slots[1] + largest


def _dense_d32_layout(shapes: Shapes, lq: int, lvs, tile, win: int):
    """``_layout`` of K9's D = 32 body (bf16): the f32 out tile, then W, then
    at a DENSE_D32_BOX_ALIGN-byte aligned offset one box of the largest
    staged level's pixels, re-used by every level, then the box's mbarrier
    (csrc/msda_fwd_dense.cu: dense_layout); no query windows (a finer level
    is read from device memory)."""
    hq, wq = shapes[lq]
    boxes, k_max = [], 16
    for lv in lvs:
        if finer(shapes[lq], shapes[lv]):
            boxes.append((0, 0))
            continue
        hv, wv = shapes[lv]
        box = (box_extent(tile[0], hq, hv, win), box_extent(tile[1], wq, wv, win))
        boxes.append(box)
        k_max = max(k_max, _round_up(box[0] * box[1], 16))
    w_stride = _round_up(k_max, 32) + 8
    box_at = _round_up(DENSE_D32_ROWS * DENSE_D32_OUT_ROW * 4 + DENSE_D32_ROWS * w_stride * 4,
                       DENSE_D32_BOX_ALIGN)
    smem = box_at + k_max * DENSE_D32_BOX_ROW + DENSE_D32_BARRIER
    return tuple(boxes), (0,) * len(boxes), 0, 0, smem


def _layout(kernel, shapes: Shapes, lq: int, lvs, tile, head_dim: int, esize: int, win: int,
            body: str = "general"):
    """(boxes, box element offsets, window offset, tap byte offset, shared
    bytes) of one launch at a tile. K8 holds every box at once; the other
    kernels re-use one box buffer for their levels."""
    if body == "d32":
        if kernel == "msda_fwd_dense":
            return _dense_d32_layout(shapes, lq, lvs, tile, win)
        if kernel == "msda_fwd_rows":
            return _ring_layout(shapes, lq, lvs, tile, esize, win)
        return _d32_layout(shapes, lq, lvs, tile, esize, win)
    hq, wq = shapes[lq]
    boxes, offsets, total, widest = [], [], 0, 0
    for lv in lvs:
        if finer(shapes[lq], shapes[lv]):
            boxes.append((0, 0))
            offsets.append(0)
            continue
        hv, wv = shapes[lv]
        box = (box_extent(tile[0], hq, hv, win), box_extent(tile[1], wq, wv, win))
        elems = box[0] * box[1] * head_dim
        boxes.append(box)
        offsets.append(total if kernel == "msda_fwd_qlevel" else 0)
        total += elems
        widest = max(widest, elems)
    win_off = total if kernel == "msda_fwd_qlevel" else widest
    windows = any(b == (0, 0) for b in boxes)
    elems = win_off + (WARPS * win * win * head_dim if windows else 0)
    tap_off = -(-elems * esize // 16) * 16
    smem = tap_off + (WARPS * (win * win + 3 * MAX_POINTS) * 4 if kernel == "msda_fwd_dense" else 0)
    return tuple(boxes), tuple(offsets), win_off, tap_off, smem


def _tiles(kernel: str, hq: int, wq: int, body: str = "general"):
    tiles = TILES
    if body == "d32":
        tiles = DENSE_D32_TILES if kernel == "msda_fwd_dense" else D32_TILES
    seen = []
    for ty, tx in tiles:
        t = (min(ty, hq), min(tx, wq))
        if t not in seen:
            seen.append(t)
    return seen


def _fit(kernel, shapes, lq, lvs, head_dim, esize, win, budget, tiles=None, body="general"):
    """The largest tile at which the launch fits ``budget`` bytes, with its
    layout; None if none does."""
    for tile in tiles or _tiles(kernel, *shapes[lq], body):
        layout = _layout(kernel, shapes, lq, lvs, tile, head_dim, esize, win, body)
        if layout[-1] <= budget:
            return tile, layout
    return None


def _launch(kernel, shapes, lq, lvs, head_dim, esize, win, budget, out_mode, body="general"):
    fit = _fit(kernel, shapes, lq, lvs, head_dim, esize, win, budget, body=body)
    if fit is None:
        raise ValueError(f"{kernel}: query level {shapes[lq]} with value levels {lvs} fits no "
                         f"tile in {budget} bytes of shared memory")
    tile, (boxes, _, _, _, smem) = fit
    return Launch(kernel, (lq,), tuple(lvs), tile, boxes, smem, out_mode, body)


def single_launch(kernel: str, spatial_shapes, lq: int, value_levels: Sequence[int],
                  head_dim: int, esize: int, radius: float, out_mode: str = "value",
                  body: str = "general") -> Launch:
    """One launch of a form kernel for query level lq over the given value
    levels, on ``body``, at the largest tile that fits a block: what the race
    times per pair."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return _launch(kernel, shapes, lq, list(value_levels), head_dim, esize, window_taps(radius),
                   SMEM_LIMIT, out_mode, body)


def _qlevel_groups(shapes, lq, head_dim, esize, win, budget, body):
    """v5's greedy packing: a level joins the current group while the group
    still fits at the query level's default tile."""
    default = _tiles("msda_fwd_qlevel", *shapes[lq], body)[:1]
    groups, cur = [], []
    for lv in range(len(shapes)):
        if cur and _fit("msda_fwd_qlevel", shapes, lq, cur + [lv], head_dim, esize, win,
                        budget, default, body) is None:
            groups.append(cur)
            cur = []
        cur.append(lv)
    return groups + [cur]


def dense_body(head_dim: int, esize: int) -> str:
    """K9's body for a launch: "d32" at head width 32 with a bf16 value (2
    bytes an element), else "general": the D = 32 body's products round V
    to bf16, which an f32 value's 1e-5 bound does not allow."""
    return "d32" if head_dim == 32 and esize == 2 else "general"


def form_body(form: str, head_dim: int, esize: int) -> str:
    """The body a form's own kernels take by default: K6's, K7's and K8's by
    the head width as K1's (``msda_dispatch.fwd_body``), K9's by
    ``dense_body``; K1 (``gather``) has its own rule."""
    from ape_tpu_torch.ops.msda_dispatch import fwd_body

    if form == "dense":
        return dense_body(head_dim, esize)
    return fwd_body(head_dim)


def plan_layer(form: str, spatial_shapes: Sequence[Tuple[int, int]], head_dim: int,
               esize: int, radius: float, budget: int = SMEM_LIMIT,
               body: str | None = None) -> Tuple[Launch, ...]:
    """The launches of one encoder layer's window MSDA under a form, for a
    value of ``esize`` bytes an element; K6-K9 take their body by
    ``form_body`` unless ``body`` (``BODIES``) says. Pure Python: no card
    needed; each plan is made once and kept, as the wrappers ask for it at
    every call."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    body = form_body(form, head_dim, esize) if body is None else body
    if body not in BODIES or (body == "d32" and head_dim != 32):
        raise ValueError(f"{form}: no body {body!r} at head width {head_dim}")
    if form == "dense" and body == "d32" and esize != 2:
        raise ValueError(f"dense: no body 'd32' for a value of {esize} bytes: it takes bf16")
    return _plan_layer(form, shapes, head_dim, esize, radius, budget, body)


@functools.lru_cache(maxsize=None)
def _plan_layer(form: str, shapes: Shapes, head_dim: int, esize: int, radius: float,
                budget: int, body: str) -> Tuple[Launch, ...]:
    levels = range(len(shapes))
    win = window_taps(radius)
    if form == "gather":
        return (Launch("msda_fwd", tuple(levels), tuple(levels)),)
    plan = []
    for lq in levels:
        if form == "pair":
            for lv in levels:
                plan.append(_launch("msda_fwd_pair", shapes, lq, [lv], head_dim, esize, win,
                                    budget, "store" if lv == 0 else "continue", body))
        elif form == "rows":
            # the finer pairs first, then K7 over the rest: in a pyramid
            # from fine to coarse, each query's levels in K1's order
            fused = [lv for lv in levels if not finer(shapes[lq], shapes[lv])]
            if body == "d32" and fused != list(range(fused[0], fused[0] + len(fused))):
                raise ValueError(f"rows: K7's D = 32 body takes consecutive value levels, not "
                                 f"{fused} of {shapes}")
            runs = [("msda_fwd_pair", [lv]) for lv in levels if lv not in fused]
            for i, (kernel, lvs) in enumerate(runs + [("msda_fwd_rows", fused)]):
                plan.append(_launch(kernel, shapes, lq, lvs, head_dim, esize, win, budget,
                                    "store" if i == 0 else "continue", body))
        elif form == "qlevel":
            groups = _qlevel_groups(shapes, lq, head_dim, esize, win, budget, body)
            for i, grp in enumerate(groups):
                mode = "value" if len(groups) == 1 else ("store" if i == 0 else "continue")
                plan.append(_launch("msda_fwd_qlevel", shapes, lq, grp, head_dim, esize, win,
                                    budget, mode, body))
        elif form == "dense":
            if shapes[lq][1] % DENSE_WIDTH == 0:
                plan.append(_launch("msda_fwd_dense", shapes, lq, list(levels), head_dim, esize,
                                    win, budget, "value", body))
            elif plan and plan[-1].kernel == "msda_fwd" and plan[-1].query_levels[-1] == lq - 1:
                plan[-1] = Launch("msda_fwd", plan[-1].query_levels + (lq,), tuple(levels))
            else:
                plan.append(Launch("msda_fwd", (lq,), tuple(levels)))
        else:
            raise ValueError(f"unknown window-MSDA form {form!r}; forms are {FORMS}")
    return tuple(plan)


def launches_per_layer(plan: Sequence[Launch]) -> dict:
    """{kernel name: launches} of a plan."""
    counts = {}
    for launch in plan:
        counts[launch.kernel] = counts.get(launch.kernel, 0) + 1
    return counts


# ---- plain versions ----------------------------------------------------------


def window_pair_plain(value_lv: torch.Tensor, offsets_pair: torch.Tensor, att_pair: torch.Tensor,
                      hq: int, wq: int, hv: int, wv: int, radius: float) -> torch.Tensor:
    """One (query level, value level) pair's contribution, the counterpart of
    JAX's ``xla_pair``: value_lv (B, hv * wv, H, D), offsets_pair (B, hq * wq,
    H, P, 2) in value-level pixels (clipped here), att_pair (B, hq * wq, H,
    P) -> (B, hq * wq, H * D) f32."""
    b, q, h, _ = att_pair.shape
    yy, xx = torch.meshgrid(torch.arange(hq, dtype=torch.float32, device=value_lv.device),
                            torch.arange(wq, dtype=torch.float32, device=value_lv.device),
                            indexing="ij")
    centers = torch.stack([(xx.reshape(-1) + 0.5) / wq, (yy.reshape(-1) + 0.5) / hq], -1)
    norm = torch.tensor([wv, hv], dtype=torch.float32, device=value_lv.device)
    loc = centers[None, :, None, None, :] + offsets_pair.float().clamp(-radius, radius) / norm
    out = sample_level(value_lv.float(), loc, att_pair.float(), hv, wv)
    return out.reshape(b, q, h * value_lv.shape[-1])


def window_qlevel_plain(value: torch.Tensor, spatial_shapes, lq: int, pixel_offsets: torch.Tensor,
                        attention_weights: torch.Tensor, radius: float,
                        value_levels: Sequence[int] | None = None,
                        partial: torch.Tensor | None = None) -> torch.Tensor:
    """Query level lq's rows of the window op, the sum of its pairs in level
    order: value (B, S, H, D), pixel_offsets (B, S, H, L, P, 2),
    attention_weights (B, S, H, L, P) -> (B, H_lq * W_lq, H * D) f32. The
    plain model of one K8 launch: over ``value_levels`` (default: every
    level), its sums continued from ``partial``, the f32 rows an earlier
    group of the query level gave (out mode "continue"). Chained over a
    plan's groups it gives the whole query level."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    starts, _ = level_start_index(shapes)
    hq, wq = shapes[lq]
    rows = slice(starts[lq], starts[lq] + hq * wq)
    out = partial
    for lv in range(len(shapes)) if value_levels is None else value_levels:
        hv, wv = shapes[lv]
        part = window_pair_plain(value[:, starts[lv]:starts[lv] + hv * wv],
                                 pixel_offsets[:, rows, :, lv], attention_weights[:, rows, :, lv],
                                 hq, wq, hv, wv, radius)
        out = part if out is None else out + part
    return out


def window_plain(value: torch.Tensor, spatial_shapes, pixel_offsets: torch.Tensor,
                 attention_weights: torch.Tensor, radius: float) -> torch.Tensor:
    """The whole window op, plain: clip, locations, exact gather. (B, Q, H * D)."""
    from ape_tpu_torch.ops.msda_dispatch import window_locations

    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return ms_deform_attn(value, shapes, window_locations(shapes, pixel_offsets, radius),
                          attention_weights)


# ---- the CUDA wrappers -------------------------------------------------------


def _check(form, value, spatial_shapes, pixel_offsets, att):
    """Validate a form's inputs: (B, S, H, D, L, P)."""
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{form} takes f32 or bf16 value, got {value.dtype}")
    if pixel_offsets.dtype != torch.float32:
        raise TypeError(f"{form} takes f32 pixel offsets, got {pixel_offsets.dtype}")
    if att.dtype not in (value.dtype, torch.float32):
        raise TypeError(f"{form} takes attention weights in {value.dtype} or f32, got {att.dtype}")
    if value.dim() != 4:
        raise ValueError(f"{form}: value {tuple(value.shape)} is not (B, S, H, D)")
    b, s, h, d = value.shape
    if pixel_offsets.dim() != 6 or tuple(pixel_offsets.shape[:3]) != (b, s, h) \
            or pixel_offsets.shape[-1] != 2:
        raise ValueError(f"{form}: pixel offsets {tuple(pixel_offsets.shape)} do not match value "
                         f"{tuple(value.shape)} (the queries are the pyramid grid)")
    l, p = pixel_offsets.shape[3], pixel_offsets.shape[4]
    if tuple(att.shape) != (b, s, h, l, p):
        raise ValueError(f"{form}: attention weights {tuple(att.shape)} != {(b, s, h, l, p)}")
    if len(spatial_shapes) != l or level_start_index(spatial_shapes)[1] != s:
        raise ValueError(f"{form}: value length {s} / {l} levels do not match {spatial_shapes}")
    if not 1 <= l <= MAX_LEVELS or not 1 <= p <= MAX_POINTS:
        raise ValueError(f"{form} takes 1-{MAX_LEVELS} levels and 1-{MAX_POINTS} points")
    if d > 32 or (d * value.element_size()) % 16:
        raise ValueError(f"{form} takes a head width D <= 32 of whole 16-byte rows, got {d}")
    for t in (value, pixel_offsets, att):
        if not t.is_cuda or t.device != value.device:
            raise ValueError(f"{form} takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{form} takes contiguous tensors")
    if value.data_ptr() % 16:
        raise ValueError(f"{form} takes a 16-byte aligned value")
    return b, s, h, d, l, p


@functools.lru_cache(maxsize=None)
def _plan_ints(launch: Launch, shapes: Shapes, sizes, esize: int, win: int) -> ctypes.Array:
    """The int plan that ``csrc/msda_window.cuh``'s parse_plan reads (made
    once per launch and sizes, and never written)."""
    b, s, h, d, l, p = sizes
    lq = launch.query_levels[0]
    starts, _ = level_start_index(shapes)
    _, offsets, win_off, tap_off, smem = _layout(launch.kernel, shapes, lq, launch.value_levels,
                                                 launch.tile, d, esize, win, launch.body)
    hq, wq = shapes[lq]
    ints = [b, s, s, h, d, l, p, hq, wq, starts[lq], launch.tile[0], launch.tile[1],
            OUT_MODES[launch.out_mode], len(launch.value_levels), smem, win, win_off, tap_off]
    for (hh, ww), st in zip(shapes, starts):
        ints += [hh, ww, st]
    for lv, box, off in zip(launch.value_levels, launch.boxes, offsets):
        ints += [lv, box[0], box[1], off]
    return (ctypes.c_int * len(ints))(*ints)


# csrc/msda_window.cuh's codes for tensor maps a D = 32 entry could not make
TENSOR_MAP_ERRORS = {-1: "libcuda has no cuTensorMapEncodeTiled",
                     -2: "cuTensorMapEncodeTiled refused a level's tensor map"}


# The entries' arguments, by name: the general entries' (csrc/msda_window.cuh:
# APE_MSDA_WINDOW_ENTRY); K6's and K7's D = 32 entries add the grid centers,
# K8's its variant; K9's D = 32 entry takes a bf16 value only, and its variant.
_GENERAL_ARGS = ("value", "off", "att", "out", "plan", "radius", "bf16", "att_f32", "stream")
_CENTERS_ARGS = ("value", "off", "att", "centers", "out", "plan", "radius", "bf16", "att_f32",
                 "stream")
_QLEVEL_D32_ARGS = _CENTERS_ARGS[:-1] + ("variant", "stream")
_DENSE_D32_ARGS = ("value", "off", "att", "out", "plan", "radius", "att_f32", "variant", "stream")
_WHOLE = {"whole": 0}
# (kernel, body) -> the library entry that launches it, its arguments, and
# the variants it runs (the op, "whole", or one of its parts)
ENTRIES = {
    ("msda_fwd_pair", "general"): ("ape_msda_fwd_pair", _GENERAL_ARGS, _WHOLE),
    ("msda_fwd_rows", "general"): ("ape_msda_fwd_rows", _GENERAL_ARGS, _WHOLE),
    ("msda_fwd_qlevel", "general"): ("ape_msda_fwd_qlevel", _GENERAL_ARGS, _WHOLE),
    ("msda_fwd_dense", "general"): ("ape_msda_fwd_dense", _GENERAL_ARGS, _WHOLE),
    ("msda_fwd_pair", "d32"): ("ape_msda_fwd_pair_d32", _CENTERS_ARGS, _WHOLE),
    ("msda_fwd_rows", "d32"): ("ape_msda_fwd_rows_d32", _CENTERS_ARGS, _WHOLE),
    ("msda_fwd_qlevel", "d32"): ("ape_msda_fwd_qlevel_d32", _QLEVEL_D32_ARGS, D32_VARIANTS),
    ("msda_fwd_dense", "d32"): ("ape_msda_fwd_dense_d32", _DENSE_D32_ARGS, DENSE_D32_VARIANTS),
}


def launch_cuda(launch: Launch, value: torch.Tensor, spatial_shapes, pixel_offsets: torch.Tensor,
                att: torch.Tensor, out: torch.Tensor, radius: float,
                variant: str = "whole") -> None:
    """Launch one of a plan's form kernels into ``out`` (B, S, H * D): the
    value's dtype for out mode "value", else f32. Each (kernel, body) has its
    one entry (``ENTRIES``); K8's D = 32 body runs as ``variant``
    (``D32_VARIANTS``), K9's as ``variant`` (``DENSE_D32_VARIANTS``), the
    others only as "whole". A D = 32 body raises if its TMA tensor maps cannot
    be made, and nothing else runs in its place."""
    from ape_tpu_torch.ops.msda_dispatch import grid_centers

    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    sizes = _check(launch.kernel, value, shapes, pixel_offsets, att)
    b, s, h, d = sizes[:4]
    want = value.dtype if launch.out_mode == "value" else torch.float32
    if out.dtype != want or tuple(out.shape) != (b, s, h * d) or not out.is_contiguous() \
            or out.device != value.device:
        raise ValueError(f"{launch.kernel}: out {out.dtype} {tuple(out.shape)} is not a "
                         f"contiguous {want} {(b, s, h * d)} on the value's device")
    entry, args, variants = ENTRIES[(launch.kernel, launch.body)]
    if variant not in variants:
        raise ValueError(f"{launch.kernel}: the {launch.body} body runs {tuple(variants)}, "
                         f"not {variant!r}")
    if launch.body == "d32" and (d != 32 or out.data_ptr() % 16):
        raise ValueError(f"{launch.kernel}: the D = 32 body takes head width 32 and a "
                         f"16-byte aligned out, got {d}")
    if launch.body == "d32" and launch.kernel == "msda_fwd_dense" \
            and value.dtype != torch.bfloat16:
        raise ValueError(f"{launch.kernel}: the D = 32 body takes a bf16 value, got "
                         f"{value.dtype}")
    given = dict(value=value.data_ptr(), off=pixel_offsets.data_ptr(), att=att.data_ptr(),
                 out=out.data_ptr(), plan=_plan_ints(launch, shapes, sizes, value.element_size(),
                                                     window_taps(radius)),
                 radius=float(radius), bf16=int(value.dtype == torch.bfloat16),
                 att_f32=int(att.dtype == torch.float32), variant=variants[variant],
                 stream=torch.cuda.current_stream(value.device).cuda_stream)
    if launch.body == "d32":
        given["centers"] = grid_centers(shapes, value.device).data_ptr()
    err = getattr(_build.library(), entry)(*(given[k] for k in args))
    if launch.body == "d32" and err in TENSOR_MAP_ERRORS:
        raise RuntimeError(f"{launch.kernel}: no TMA tensor map: {TENSOR_MAP_ERRORS[err]} "
                           f"(boxes {launch.boxes}, {torch.cuda.get_device_name()})")
    _build.check(err, launch.kernel)
    _build.LAUNCHES[launch.kernel] += 1


def window_form_cuda(form: str, value: torch.Tensor, spatial_shapes, pixel_offsets: torch.Tensor,
                     att: torch.Tensor, radius: float, body: str | None = None,
                     budget: int = SMEM_LIMIT) -> torch.Tensor:
    """The window op under a form on CUDA tensors: value (B, S, H, D),
    pixel_offsets (B, S, H, L, P, 2) f32, att (B, S, H, L, P) -> (B, S, H *
    D) in the value's dtype, by the form's plan (``plan_layer``, with the
    form's ``body`` and the shared-memory ``budget``)."""
    from ape_tpu_torch.ops import msda_dispatch

    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    d = _check(form, value, shapes, pixel_offsets, att)[3]
    plan = plan_layer(form, shapes, d, value.element_size(), radius, budget, body)
    return run_plan(plan, value, shapes, pixel_offsets, att, radius, launch_cuda,
                    msda_dispatch.msda_fwd_cuda)


def run_plan(plan: Sequence[Launch], value, shapes: Shapes, pixel_offsets, att, radius,
             launch, gather) -> torch.Tensor:
    """Run a plan's launches: ``launch(x, value, shapes, pixel_offsets, att,
    out, radius)`` for a form kernel, ``gather(value, shapes, loc, att)`` (K1)
    for a run of query levels. Launches of out mode "value" write the output
    in the value's dtype; the others store f32 partials and continue from
    them, and the partials are cast once a query level's launches have all
    run."""
    from ape_tpu_torch.ops import msda_dispatch

    b, s, h, d = value.shape
    starts, _ = level_start_index(shapes)
    out = torch.empty(b, s, h * d, dtype=value.dtype, device=value.device)
    buf = out
    if value.dtype != torch.float32 and any(x.out_mode != "value" for x in plan):
        buf = torch.empty(b, s, h * d, dtype=torch.float32, device=value.device)
    partial = []
    for x in plan:
        first, last = x.query_levels[0], x.query_levels[-1]
        rows = slice(starts[first], starts[last] + shapes[last][0] * shapes[last][1])
        if x.kernel == "msda_fwd":  # K1 over a run of query levels
            loc = msda_dispatch.window_locations(shapes, pixel_offsets[:, rows], radius,
                                                 first_query=rows.start)
            out[:, rows] = gather(value, shapes, loc.contiguous(), att[:, rows].contiguous())
            continue
        launch(x, value, shapes, pixel_offsets, att, out if x.out_mode == "value" else buf, radius)
        if x.out_mode != "value" and rows not in partial:
            partial.append(rows)
    if buf is not out:
        for rows in partial:
            out[:, rows] = buf[:, rows]
    return out
