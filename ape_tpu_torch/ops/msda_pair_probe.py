"""The pair probe (K10): one (query level, value level) pair of K1's gather
in variants that each change or skip one stage, and their plain versions.

The counterpart of the JAX repository's ``experiments/pair_probe.py``, whose
``run_pair_variant`` runs the v2 window-MSDA pair kernel in about fifteen
variants to split its time by stage. The port's pair kernel is K1
(``csrc/msda_fwd.cu``) on one value level; ``csrc/msda_pair_probe.cu`` runs
it in the eight ``VARIANTS`` (its header says what each keeps and drops).
Every variant takes the pair's clipped normalized locations, as K1 takes
them (``pair_locations``), and writes f32 (B, Q, H * D), as the TPU kernel
does; ``base`` rounded to the value's dtype is K1's output on the pair.
Each plain version computes what its variant computes: ``bf16fma``'s
rounds as the kernel's bf16 blend rounds, once a corner from the exact
product and sum (``__hfma2``), so it sits up to a few bf16 steps from
``base``'s at the probe's sizes.

``pair_probe`` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors; ``pair_probe_cuda`` launches or raises.

Layout: value (B, hv * wv, H, D) with D = 32, locations (B, Q, H, P, 2) f32,
attention weights (B, Q, H, P) f32. (The TPU probe keeps channels head-minor,
c = d * H + h; the port keeps K1's h * D + d.)
"""

from __future__ import annotations

import torch

from ape_tpu_torch.ops import _build
from ape_tpu_torch.ops.msda import sample_level
from ape_tpu_torch.ops.msda_dispatch import grid_centers

VARIANTS = ("base", "vec2", "bf16fma", "branchless", "const_w", "corners_only", "no_corners",
            "store_only")
# Each variant of the TPU probe (experiments/pair_probe.py make_kernel) and
# the port's variant that does its work: the full function in the same or
# another layout, or the same stage skipped.
JAX_VARIANTS = {"base": "base", "k32": "base", "tile": "vec2", "k32_t": "vec2",
                "bf16fma": "bf16fma", "k32_bf16": "bf16fma",
                "u8": "branchless", "u4": "branchless", "uskip": "branchless",
                "const_w": "const_w", "viewonly": "corners_only", "no_fma": "no_corners",
                "k32_nofma": "no_corners", "k32_t_nofma": "no_corners", "dma_only": "store_only"}
# (hq, wq, hv, wv) as experiments/pair_probe.py's PAIRS
PAIRS = {"same": (256, 256, 256, 256), "inv2": (256, 256, 128, 128),
         "inv4": (256, 256, 64, 64), "sx2": (128, 128, 256, 256)}
HEADS, HEAD_DIM, POINTS, RADIUS = 8, 32, 4, 4  # the TPU probe's H, D, P and radius
CONST_W = 0.01  # const_w's weight of every corner


def pair_locations(offsets, hq: int, wq: int, hv: int, wv: int, radius: float) -> torch.Tensor:
    """f32 locations of a pair's samples, ``center + clip(off, -R, R) /
    size``, rounded as ``msda_dispatch.window_locations`` rounds them:
    offsets (B, hq * wq, H, P, 2) in value-level pixels -> (B, hq * wq, H, P, 2)."""
    centers = grid_centers(((hq, wq),), offsets.device)
    norm = torch.tensor([wv, hv], dtype=torch.float32, device=offsets.device)
    return centers[None, :, None, None, :] + offsets.float().clamp(-radius, radius) / norm


def _corner_rows(value_lv, loc_pair, hv: int, wv: int):
    """The four corners of every sample, as the kernel finds them: [(rows
    (B, Q, H, P, D) f32, in-level and live mask (B, Q, H, P), bilinear weight
    (B, Q, H, P))]. A sample is live where -1 <= x < wv and -1 <= y < hv
    (``msda_sample.cuh``'s ``live``: at pixel -1 its corners' weights are 0)."""
    b, q, h, p, _ = loc_pair.shape
    d = value_lv.shape[-1]
    x = loc_pair[..., 0] * wv - 0.5
    y = loc_pair[..., 1] * hv - 0.5
    live = (x >= -1) & (y >= -1) & (x < wv) & (y < hv)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    ix0 = x0.clamp(-2, wv + 1).nan_to_num(-2).long()
    iy0 = y0.clamp(-2, hv + 1).nan_to_num(-2).long()
    rows = value_lv.float().permute(0, 2, 1, 3).reshape(b * h, hv * wv, d)
    corners = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ix, iy = ix0 + dx, iy0 + dy
        inside = live & (ix >= 0) & (ix < wv) & (iy >= 0) & (iy < hv)
        lin = iy.clamp(0, hv - 1) * wv + ix.clamp(0, wv - 1)
        idx = lin.permute(0, 2, 1, 3).reshape(b * h, q * p, 1).expand(-1, -1, d)
        g = torch.gather(rows, 1, idx).reshape(b, h, q, p, d).permute(0, 2, 1, 3, 4)
        corners.append((g, inside, (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)))
    return corners


def _fma_bf16(v: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """v + term rounded once to bf16, to nearest, ties to even, as an FMA
    rounds its exact result (``(v + term).to(torch.bfloat16)`` would round
    to f32 first). f64 in and out. The f64 sum's rounding error (TwoSum)
    decides a sum that lands on a tie."""
    s = v + term
    vv = s - term
    err = (v - vv) + (term - (s - vv))
    m, e = torch.frexp(s)  # |m| in [0.5, 1): 8 significant bits are m * 256
    t = m * 256
    low = torch.floor(t)
    tie = (t - low == 0.5) & (err != 0)
    return torch.ldexp(torch.where(tie, low + (err > 0).double(), torch.round(t)), e - 8)


def _bf16_blend(value_lv, loc_pair, att_pair, hv: int, wv: int) -> torch.Tensor:
    """bf16fma's function: each live sample's in-level corners blended in
    bf16 in the kernel's order, as ``__hfma2`` blends them (the corner and
    its bilinear weight rounded to bf16, then the exact product plus the sum
    so far rounded once to bf16 after every corner), then times the
    attention weight and summed in f32: (B, Q, H, D). A product of two bf16
    values is exact in f64."""
    bf16 = torch.bfloat16
    v = torch.zeros((), dtype=torch.float64, device=value_lv.device)
    for g, inside, w in _corner_rows(value_lv, loc_pair, hv, wv):
        term = w.to(bf16).double()[..., None] * g.to(bf16).double()
        v = torch.where(inside[..., None], _fma_bf16(v, term), v)
    return (att_pair.float()[..., None] * v.float()).sum(3)


def pair_probe_plain(variant: str, value_lv, loc_pair, att_pair, hv: int, wv: int) -> torch.Tensor:
    """The function a variant computes, in plain torch: (B, Q, H * D) f32."""
    b, q, h, p = att_pair.shape
    d = value_lv.shape[-1]
    if variant == "bf16fma":
        out = _bf16_blend(value_lv, loc_pair.float(), att_pair, hv, wv)
    elif variant in ("base", "vec2", "branchless"):
        out = sample_level(value_lv.float(), loc_pair.float(), att_pair.float(), hv, wv)
    elif variant == "no_corners":
        ones = torch.ones(b, hv * wv, h, d, dtype=torch.float32, device=value_lv.device)
        out = sample_level(ones, loc_pair.float(), att_pair.float(), hv, wv)
    elif variant in ("const_w", "corners_only"):
        out = sum((g * inside[..., None]).sum(3)
                  for g, inside, _ in _corner_rows(value_lv, loc_pair.float(), hv, wv))
        if variant == "const_w":
            out = CONST_W * out
    elif variant == "store_only":
        out = att_pair.float().sum(-1, keepdim=True).expand(b, q, h, d)
    else:
        raise ValueError(f"unknown pair-probe variant {variant!r}; variants are {VARIANTS}")
    return out.reshape(b, q, h * d)


def _check(value_lv, loc_pair, att_pair, hv: int, wv: int):
    """(B, Q, H, P) of valid inputs on one CUDA device."""
    if value_lv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"msda_pair_probe takes f32 or bf16 value, got {value_lv.dtype}")
    if loc_pair.dtype != torch.float32 or att_pair.dtype != torch.float32:
        raise TypeError(f"msda_pair_probe takes f32 locations and attention weights, "
                        f"got {loc_pair.dtype} and {att_pair.dtype}")
    if value_lv.dim() != 4 or value_lv.shape[1] != hv * wv or value_lv.shape[-1] != HEAD_DIM:
        raise ValueError(f"msda_pair_probe takes value (B, {hv} * {wv}, H, {HEAD_DIM}), "
                         f"got {tuple(value_lv.shape)}")
    b, _, h, _ = value_lv.shape
    if att_pair.dim() != 4 or tuple(att_pair.shape[::2]) != (b, h):
        raise ValueError(f"attention weights {tuple(att_pair.shape)} do not match value "
                         f"{tuple(value_lv.shape)}")
    if tuple(loc_pair.shape) != (*att_pair.shape, 2):
        raise ValueError(f"locations {tuple(loc_pair.shape)} != {(*att_pair.shape, 2)}")
    for t in (value_lv, loc_pair, att_pair):
        if not t.is_cuda or t.device != value_lv.device:
            raise ValueError("msda_pair_probe takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("msda_pair_probe takes contiguous tensors")
    return tuple(att_pair.shape)


def pair_probe_cuda(variant: str, value_lv, loc_pair, att_pair, hv: int, wv: int) -> torch.Tensor:
    """Launch ``csrc/msda_pair_probe.cu`` in one variant: (B, Q, H * D) f32."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown pair-probe variant {variant!r}; variants are {VARIANTS}")
    b, q, h, p = _check(value_lv, loc_pair, att_pair, hv, wv)
    out = torch.empty(b, q, h * HEAD_DIM, dtype=torch.float32, device=value_lv.device)
    err = _build.library().ape_msda_pair_probe(
        value_lv.data_ptr(), loc_pair.data_ptr(), att_pair.data_ptr(), out.data_ptr(), b, q, h, p,
        hv, wv, HEAD_DIM, VARIANTS.index(variant), int(value_lv.dtype == torch.bfloat16),
        torch.cuda.current_stream(value_lv.device).cuda_stream)
    _build.check(err, "msda_pair_probe")
    _build.LAUNCHES["msda_pair_probe"] += 1
    return out


def pair_probe(variant: str, value_lv, loc_pair, att_pair, hv: int, wv: int) -> torch.Tensor:
    """A variant on one pair: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if value_lv.is_cuda:
        return pair_probe_cuda(variant, value_lv, loc_pair, att_pair, hv, wv)
    if value_lv.device.type == "cpu":
        if variant not in VARIANTS:
            raise ValueError(f"unknown pair-probe variant {variant!r}; variants are {VARIANTS}")
        return pair_probe_plain(variant, value_lv, loc_pair, att_pair, hv, wv)
    raise ValueError(f"no pair-probe implementation for device {value_lv.device}")
