"""Image and annotation transforms without PIL (counterpart of
``ape_tpu/data/transforms.py``): large-scale jitter (ResizeScale 0.1-2.0 +
FixedSizeCrop + flip), the test-time shortest-edge resize, pad to a square,
boxes and masks replayed through a transform, polygon rasterization and the
COCO RLE codec.

JAX resizes, rasterizes and reads through PIL; the card machine has no PIL,
so this module reproduces PIL 12.1's results bit for bit in NumPy:

* ``pil_resize``: ``Image.resize(..., BILINEAR)`` of a uint8 ("L") or float32
  ("F") map: a triangle filter of support 1, widened by the scale when a side
  shrinks, taps past the edge dropped and the rest renormalised, one axis
  after the other (columns first), the coefficients in f64. Float maps sum
  the taps in f64 in PIL's order and store each pass as f32; uint8 maps take
  the coefficients to 22-bit fixed point, sum in integers from half a unit,
  shift and clip each pass to 0..255. An RGB image resizes channel by
  channel (``resize_image``): PIL's 8-bit passes treat the bands alike.
  ``resize_lanczos`` is the same 8-bit resize under PIL's LANCZOS filter
  (``sinc(x) sinc(x / 3)``, support 3), for the ICO writer's frames.
* ``resize_nearest``: ``Image.resize(..., NEAREST)``: PIL's scale-only affine
  transform, the source coordinate of each output pixel accumulated in f64
  from half a step, truncated.
* ``polygons_to_mask``: ``ImageDraw.polygon(xy, outline=1, fill=1)`` (the
  outline has the fill's ink, so PIL draws the fill alone): the vertices
  truncated to integers, consecutive horizontal edges merged, horizontal
  edges drawn as lines, then a scanline at each integer row through the
  others' f32 crossings (an edge's end row counted twice unless it is the
  polygon's last), corners where two edges of one slope sign meet nudged
  to the next row's crossings (``_corner``), the sorted crossings paired and
  each span filled from ``ROUND_UP`` of its start to ``ROUND_DOWN`` of its
  end, both in f32. Rows that hold no vertex take the vectorised path,
  vertex rows the exact per-row one.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


def _bilinear(x: float) -> float:
    return max(0.0, 1.0 - abs(x))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    """Resample.c's lanczos_filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


# Resample.c's filters: name -> (function, support)
FILTERS = {"bilinear": (_bilinear, 1.0), "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=256)
def _coefficients(in_size: int, out_size: int,
                  kind: str = "bilinear") -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for a filter of ``FILTERS``: per output
    pixel the first input tap (out_size,) and the tap weights (out_size,
    ksize), zero past the taps that lie inside the input. Cached by size,
    read-only."""
    kernel, filter_support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        starts[xx] = xmin
        weights[xx, :xmax] = [w / ww for w in k] if ww != 0.0 else k
    starts.flags.writeable = weights.flags.writeable = False
    return starts, weights


def _fixed_point(weights: np.ndarray) -> np.ndarray:
    """PIL's ``normalize_coeffs_8bpc``: the weights to 22-bit fixed point,
    rounded half away from zero by truncation."""
    scaled = weights * (1 << PRECISION_BITS)
    return np.where(scaled < 0, scaled - 0.5, scaled + 0.5).astype(np.int64)


def _resample(x: np.ndarray, out_size: int, axis: int, keep: slice = slice(None)) -> np.ndarray:
    """One PIL pass along ``axis`` of a float32 or uint8 array: the taps
    summed in PIL's order (a tap whose weight is 0 everywhere is skipped:
    it would add 0). ``keep``: the output pixels to compute (each depends
    on its own taps only)."""
    in_size = x.shape[axis]
    starts, weights = _coefficients(in_size, out_size)
    starts, weights = starts[keep], weights[keep]
    out_size = len(starts)
    integer = x.dtype == np.uint8
    coeffs = _fixed_point(weights) if integer else weights
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1) if integer else 0.0,
                  np.int64 if integer else np.float64)
    term = np.empty_like(acc)
    for k in range(weights.shape[1]):
        if not coeffs[:, k].any():
            continue
        taps = x.take(np.minimum(starts + k, in_size - 1), axis=axis)
        np.multiply(taps, coeffs[:, k].reshape(shape), out=term)
        acc += term
    if integer:
        return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return acc.astype(np.float32)


def pil_resize(x: np.ndarray, h: int, w: int, rows: slice = slice(None),
               cols: slice = slice(None)) -> np.ndarray:
    """``np.asarray(Image.fromarray(x).resize((w, h), Image.BILINEAR))`` for
    a float32 or uint8 array (..., H, W): columns first, then rows; a side
    that keeps its size is not resampled. ``rows`` and ``cols`` crop the
    result, and only the crop is computed."""
    if x.dtype not in (np.float32, np.uint8):
        raise TypeError(f"pil_resize takes float32 or uint8 maps, not {x.dtype}")
    x = _resample(x, w, x.ndim - 1, cols) if x.shape[-1] != w else x[..., cols]
    return _resample(x, h, x.ndim - 2, rows) if x.shape[-2] != h else x[..., rows, :]


def resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's bilinear resize of a uint8 (H, W) or (H, W, C) image to (h, w)."""
    if img.ndim == 2:
        return pil_resize(img, h, w)
    return np.ascontiguousarray(pil_resize(np.ascontiguousarray(img.transpose(2, 0, 1)), h, w)
                                .transpose(1, 2, 0))


def resize_lanczos(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``Image.resize((w, h), Image.LANCZOS)`` of a uint8 (H, W) or (H, W, C)
    image: Resample.c's 8-bit passes under the Lanczos filter (support 3),
    columns first, each pass clipped to uint8; a side that keeps its size is
    not resampled. The taps and weights are computed here
    (``_coefficients``, ``_fixed_point``), the sums by the host library's
    ``ape_resample_u8`` (``csrc/resample_host.cpp``)."""
    from ape_tpu_torch.ops._build import host_library

    src = np.ascontiguousarray(img, np.uint8)
    in_h, in_w = src.shape[:2]
    channels = 1 if src.ndim == 2 else src.shape[2]

    def plan(n_in, n_out):
        if n_in == n_out:
            return np.zeros(1, np.int64), np.zeros(1, np.int32), 0
        starts, weights = _coefficients(n_in, n_out, "lanczos")
        fixed = np.ascontiguousarray(_fixed_point(weights).astype(np.int32))
        return np.ascontiguousarray(starts), fixed, fixed.shape[1]

    hs, hw, hk = plan(in_w, w)
    vs, vw, vk = plan(in_h, h)
    out = np.empty((h, w) + src.shape[2:], np.uint8)
    host_library().ape_resample_u8(src.ctypes.data, in_w, in_h, channels, hs.ctypes.data,
                                   hw.ctypes.data, hk, w, vs.ctypes.data, vw.ctypes.data, vk, h,
                                   out.ctypes.data)
    return out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's ImagingScaleAffine source index per output pixel: the
    coordinate starts at half a step and adds the step (f64) per pixel,
    then truncates; -1 past the input."""
    step = in_size / out_size
    coords = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    idx = np.where(coords < 0.0, -1, coords.astype(np.int64))
    return np.where(idx < in_size, idx, -1)


def resize_nearest(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's NEAREST resize of an (H, W) or (H, W, C) array to (h, w)."""
    if arr.shape[:2] == (h, w):
        return arr.copy()
    ys, xs = _nearest_index(arr.shape[0], h), _nearest_index(arr.shape[1], w)
    out = np.zeros((h, w) + arr.shape[2:], arr.dtype)
    out[np.ix_(ys >= 0, xs >= 0)] = arr[np.ix_(ys[ys >= 0], xs[xs >= 0])]
    return out


@dataclasses.dataclass
class TransformRecord:
    """What happened to the image, to replay on boxes/masks/points."""

    scale: float
    flip: bool
    crop_xy: Tuple[int, int]  # offset of the crop in the resized image
    out_size: Tuple[int, int]  # (h, w) final canvas
    valid_size: Tuple[int, int]  # (h, w) of real content in the canvas


def lsj_transform(
    img: np.ndarray,
    rng: np.random.RandomState,
    out_size: int = 1024,
    min_scale: float = 0.1,
    max_scale: float = 2.0,
    flip_prob: float = 0.5,
) -> Tuple[np.ndarray, TransformRecord]:
    """ResizeScale + FixedSizeCrop + flip. Returns canvas image + record."""
    h0, w0 = img.shape[:2]
    scale = rng.uniform(min_scale, max_scale)
    # ResizeScale: target = scale * out_size, keep aspect via min ratio
    r = min(out_size * scale / h0, out_size * scale / w0)
    nh, nw = int(round(h0 * r)), int(round(w0 * r))
    img = resize_image(img, nh, nw)

    flip = rng.rand() < flip_prob
    if flip:
        img = img[:, ::-1]

    # FixedSizeCrop(out, pad=False): random crop when larger, else keep
    cy = rng.randint(0, max(nh - out_size, 0) + 1)
    cx = rng.randint(0, max(nw - out_size, 0) + 1)
    img = img[cy : cy + out_size, cx : cx + out_size]
    vh, vw = img.shape[:2]

    canvas = np.zeros((out_size, out_size, 3), img.dtype)
    canvas[:vh, :vw] = img
    return canvas, TransformRecord(r, flip, (cx, cy), (out_size, out_size), (vh, vw))


def apply_to_boxes(boxes: np.ndarray, rec: TransformRecord, orig_w: int) -> np.ndarray:
    """boxes xyxy in original pixels -> canvas pixels (clipped)."""
    b = boxes.astype(np.float64) * rec.scale
    if rec.flip:
        w = orig_w * rec.scale
        b = np.stack([w - b[:, 2], b[:, 1], w - b[:, 0], b[:, 3]], 1)
    b[:, 0::2] -= rec.crop_xy[0]
    b[:, 1::2] -= rec.crop_xy[1]
    b[:, 0::2] = b[:, 0::2].clip(0, rec.valid_size[1])
    b[:, 1::2] = b[:, 1::2].clip(0, rec.valid_size[0])
    return b.astype(np.float32)


def apply_to_mask(mask: np.ndarray, rec: TransformRecord) -> np.ndarray:
    """binary mask in original pixels -> canvas-sized mask."""
    h0, w0 = mask.shape
    nh, nw = int(round(h0 * rec.scale)), int(round(w0 * rec.scale))
    m = resize_nearest(mask.astype(np.uint8) * 255, nh, nw) > 127
    if rec.flip:
        m = m[:, ::-1]
    cx, cy = rec.crop_xy
    out_h, out_w = rec.out_size
    m = m[cy : cy + out_h, cx : cx + out_w]
    canvas = np.zeros(rec.out_size, bool)
    canvas[: m.shape[0], : m.shape[1]] = m
    return canvas


def resize_shortest_edge(
    img: np.ndarray, short: int = 1024, max_size: int = 1024
) -> Tuple[np.ndarray, float]:
    """Test-time ResizeShortestEdge (engine/defaults.py DefaultPredictor aug)."""
    h, w = img.shape[:2]
    r = short / min(h, w)
    if max(h, w) * r > max_size:
        r = max_size / max(h, w)
    nh, nw = int(round(h * r)), int(round(w * r))
    return resize_image(img, nh, nw), r


def pad_to_square(img: np.ndarray, size: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    h, w = img.shape[:2]
    canvas = np.zeros((size, size, 3), img.dtype)
    canvas[:h, :w] = img
    return canvas, (h, w)


_F32 = np.float32


def _roundf(v) -> np.float32:
    """C's ``roundf`` on an f32: half away from zero."""
    a = abs(float(v))
    r = math.floor(a)
    r = r + 1 if a - r >= 0.5 else r
    return _F32(-r if v < 0 else r)


def _round_up(f: np.ndarray) -> np.ndarray:
    """PIL's ROUND_UP of f32 values: floor(f + 0.5f), mirrored below 0."""
    f = f.astype(np.float32)
    half = _F32(0.5)
    return np.where(f >= 0, np.floor(f + half), -np.floor(np.abs(f) + half)).astype(np.int64)


def _round_down(f: np.ndarray) -> np.ndarray:
    """PIL's ROUND_DOWN of f32 values: ceil(f - 0.5f), mirrored below 0."""
    f = f.astype(np.float32)
    half = _F32(0.5)
    return np.where(f >= 0, np.ceil(f - half), -np.ceil(np.abs(f) - half)).astype(np.int64)


def _polygon_edges(pts: Sequence[Tuple[int, int]]):
    """PIL's edge list of a polygon of integer vertices: [x0, y0, ymin,
    ymax, xmin, xmax, dx, x at ymin, x at ymax] per edge, a run of horizontal edges that keeps its
    direction merged into the first, the closing edge added unless the path
    is closed."""
    edges = []

    def add(x0, y0, x1, y1):
        dx = _F32(0.0) if y0 == y1 else _F32(_F32(x1 - x0) / _F32(y1 - y0))
        top, bottom = (x0, x1) if y0 <= y1 else (x1, x0)
        edges.append([x0, y0, min(y0, y1), max(y0, y1), min(x0, x1), max(x0, x1), dx,
                      top, bottom])

    for i in range(len(pts) - 1):
        (x0, y0), (x1, y1) = pts[i], pts[i + 1]
        if y0 == y1 and i != 0 and y0 == pts[i - 1][1]:
            if x1 > x0 > pts[i - 1][0]:
                edges[-1][5] = x1
                continue
            if x1 < x0 < pts[i - 1][0]:
                edges[-1][4] = x1
                continue
        add(x0, y0, x1, y1)
    if pts[-1] != pts[0]:
        add(*pts[-1], *pts[0])
    return edges


def _x_at(edge, y) -> np.float32:
    return _F32(_F32(y - edge[1]) * edge[6] + _F32(edge[0]))


def _corner(xx: List[np.float32], i: int, y: int, table, joined) -> None:
    """PIL's corner rule: the crossing just appended for edge ``i`` at an
    end row ``y`` where an earlier edge of the same slope sign ends too (both
    at their top or both at their bottom, the crossing at the other's end
    vertex, compared exactly, not at its f32 crossing) moves past both
    edges' crossings on the next row (the previous one at a bottom), when it
    lies more than a pixel outside both."""
    cur = table[i]
    x = xx[-1]
    for k in joined:
        if k >= i:
            break
        oth = table[k]
        if (cur[6] > 0 and oth[6] <= 0) or (cur[6] < 0 and oth[6] >= 0):
            continue
        if not ((y == cur[2] and y == oth[2]) or (y == cur[3] and y == oth[3])):
            continue
        if x != (oth[7] if y == oth[2] else oth[8]):
            continue
        nxt = y - 1 if y == cur[3] else y + 1
        if not oth[2] <= nxt <= oth[3]:
            continue
        a, b = _x_at(cur, nxt), _x_at(oth, nxt)
        if x > a + 1 and x > b + 1:
            xx[-1] = _F32(_roundf(max(a, b)) + _F32(1))
        elif x < a - 1 and x < b - 1:
            xx[-1] = _F32(_roundf(min(a, b)) - _F32(1))
        return


def _fill_polygon(out: np.ndarray, pts: Sequence[Tuple[int, int]]) -> None:
    """Fill one polygon of integer vertices into ``out`` (h, w) as PIL's
    ``polygon_generic`` does (module docstring)."""
    h, w = out.shape
    edges = _polygon_edges(pts)
    spans = []  # (row, first x, last x) before clipping

    ymin, ymax = h - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e[2]), max(ymax, e[3])
        if e[2] == e[3]:
            spans.append((e[2], e[4], e[5]))
        else:
            table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, h)
    if table and ymin <= ymax:
        y0 = np.array([e[1] for e in table], np.int64)
        x0 = np.array([e[0] for e in table], np.float32)
        dx = np.array([e[6] for e in table], np.float32)
        lo = np.array([e[2] for e in table], np.int64)
        hi = np.array([e[3] for e in table], np.int64)
        vertex_rows = set(lo.tolist()) | set(hi.tolist())
        rows = np.arange(ymin, ymax + 1)
        plain = rows[~np.isin(rows, list(vertex_rows))]
        if plain.size:
            active = (lo[None] < plain[:, None]) & (plain[:, None] < hi[None])
            xs = (plain[:, None] - y0[None]).astype(np.float32) * dx[None] + x0[None]
            xs = np.sort(np.where(active, xs, np.float32(np.inf)), axis=1)
            count = active.sum(1)
            for p in range(int(count.max()) // 2):
                ok = 2 * p + 1 < count
                spans += zip(plain[ok].tolist(), _round_up(xs[ok, 2 * p]).tolist(),
                             _round_down(xs[ok, 2 * p + 1]).tolist())
        for y in sorted(r for r in vertex_rows if ymin <= r <= ymax):
            joined = [i for i, e in enumerate(table) if y == e[2] or y == e[3]]
            xx: List[np.float32] = []
            for i, e in enumerate(table):
                if not e[2] <= y <= e[3]:
                    continue
                xx.append(_x_at(e, y))
                if y == e[3] and y < ymax:
                    xx.append(xx[-1])
                elif e[6] != 0 and _roundf(xx[-1]) == xx[-1]:
                    _corner(xx, i, y, table, joined)
            xx.sort()
            arr = np.array(xx, np.float32)
            spans += zip([y] * (len(xx) // 2), _round_up(arr[0:len(xx) - 1:2]).tolist(),
                         _round_down(arr[1::2]).tolist())
    for y, a, b in spans:  # PIL's hline: clip to the image, inclusive ends
        if 0 <= y < h and a < w and b >= 0:
            out[y, max(a, 0):min(b, w - 1) + 1] = True


def polygons_to_mask(polygons: List[np.ndarray], h: int, w: int) -> np.ndarray:
    """COCO polygon list -> (h, w) bool, as JAX's PIL rasterization: each
    polygon of 3 or more points drawn with ``ImageDraw.polygon(xy,
    outline=1, fill=1)`` (module docstring), vertices truncated to integers
    as PIL's C layer takes them."""
    out = np.zeros((h, w), bool)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) >= 3:
            _fill_polygon(out, [(int(x), int(y)) for x, y in pts.tolist()])
    return out

# ---------------------------------------------------------------------------
# COCO RLE codec (replaces pycocotools mask API for decode/encode/iou)
# ---------------------------------------------------------------------------

def rle_decode(rle: Dict, h: Optional[int] = None, w: Optional[int] = None) -> np.ndarray:
    """Decode COCO RLE (counts list or LEB128-style string) to (h, w) bool."""
    if h is None or w is None:
        h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _rle_string_to_counts(
            counts.encode() if isinstance(counts, str) else counts
        )
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape(w, h).T  # column-major


def rle_encode(mask: np.ndarray) -> Dict:
    """Encode (h, w) bool mask to COCO compressed RLE."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    # run lengths starting with zeros
    diffs = np.nonzero(np.diff(flat))[0] + 1
    starts = np.concatenate([[0], diffs])
    ends = np.concatenate([diffs, [len(flat)]])
    counts = (ends - starts).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": _counts_to_rle_string(counts)}


def _counts_to_rle_string(counts) -> bytes:
    """pycocotools-compatible LEB128-ish encoding with delta for even runs."""
    out = bytearray()
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _rle_string_to_counts(s: bytes):
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_iou(a: Dict, b: Dict) -> float:
    ma, mb = rle_decode(a), rle_decode(b)
    inter = np.logical_and(ma, mb).sum()
    union = np.logical_or(ma, mb).sum()
    return float(inter) / max(float(union), 1.0)
