"""Copy-paste augmentation (counterpart of ``ape_tpu/data/copypaste.py``):
paste a foreground example's instances, largest first, onto a background
example's canvas away from its existing foreground, blending the edges of
large masks, and append them as targets. ``CopyPasteMapper`` pairs each
record with a background drawn from a pool.

JAX resizes and blurs with PIL. Here PIL's NEAREST resize is
``transforms.resize_nearest`` and PIL's ``ImageFilter.GaussianBlur`` is
``gaussian_blur``, Pillow's box blur in NumPy bit for bit; the blend is f32
in JAX's order (``alpha / 255``, the 0.5 clamps, ``img (1 - a) + fg a``),
so an example equals JAX's for the same inputs and generator.

The draws of ``CopyPasteMapper`` are JAX's, in its order: the foreground
through the base mapper (its own generator), then ``rand`` and ``randint``
from the copy-paste generator, then the background through the base mapper.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ape_tpu_torch.data.transforms import resize_nearest


def _box_blur_radius(radius: float, passes: int) -> np.float32:
    """Pillow's ``_gaussian_blur_radius``: the box radius (whole and
    fractional part) whose ``passes`` box blurs match a Gaussian of standard
    deviation ``radius``, in C's float and double arithmetic."""
    f = np.float32
    sigma2 = f(radius) * f(radius) / f(passes)
    big_l = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(math.floor((float(big_l) - 1.0) / 2.0))
    a = (f(2) * small_l + f(1)) * (small_l * (small_l + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (small_l + f(1)) * (small_l + f(1))))
    return f(small_l + a)


def _box_blur_rows(img: np.ndarray, radius: np.float32) -> np.ndarray:
    """One pass of Pillow's ``ImagingHorizontalBoxBlur`` over each row of an
    (H, W) uint8 image: the sum of the 2r + 1 pixels around each one (the
    edge pixels repeated), weighted ``ww`` in 2^24ths, plus the two next
    pixels weighted ``fw`` for the fractional radius, rounded back to uint8."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    w = img.shape[1]
    idx = np.clip(np.arange(-r - 1, w + r + 1), 0, w - 1)
    padded = img[:, idx].astype(np.int64)  # padded[:, j] = pixel j - r - 1, clamped
    csum = np.concatenate([np.zeros((img.shape[0], 1), np.int64), np.cumsum(padded, 1)], 1)
    acc = csum[:, 2 * r + 2:2 * r + 2 + w] - csum[:, 1:1 + w]  # pixels x - r .. x + r
    bulk = acc * ww + (padded[:, :w] + padded[:, 2 * r + 2:2 * r + 2 + w]) * fw
    return ((bulk + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """PIL's ``Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius))``
    of an (H, W) uint8 image: ``passes`` box blurs along the rows, then
    ``passes`` along the columns, each rounded to uint8."""
    box = _box_blur_radius(radius, passes)
    out = np.asarray(img, np.uint8)
    if box == 0:
        return out.copy()
    for _ in range(passes):
        out = _box_blur_rows(out, box)
    out = out.T
    for _ in range(passes):
        out = _box_blur_rows(out, box)
    return np.ascontiguousarray(out.T)


def _blurred_mask(mask: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """``gaussian_blur`` of a 0/255 mask, computed on the mask's box grown by
    the blur's reach: each pass widens the support by the box radius + 1, so
    the crop's edge stays 0 through every pass and the result equals the
    whole image's blur, which is 0 outside the crop."""
    ys, xs = np.nonzero(mask)
    reach = passes * (int(_box_blur_radius(radius, passes)) + 1) + 1
    y0, y1 = max(ys.min() - reach, 0), min(ys.max() + reach + 1, mask.shape[0])
    x0, x1 = max(xs.min() - reach, 0), min(xs.max() + reach + 1, mask.shape[1])
    out = np.zeros_like(mask)
    out[y0:y1, x0:x1] = gaussian_blur(mask[y0:y1, x0:x1], radius, passes)
    return out


def copypaste(
    fg_example: Dict,
    bg_example: Dict,
    rng: np.random.RandomState,
    max_paste: int = 20,
    blend_sigma: float = 5.0,
    blend_min_area: int = 64 * 64,
) -> Dict:
    """Paste fg instances (with masks) onto the bg canvas.

    Both examples are mapper outputs (fixed-shape targets + canvas image).
    Returns a new example based on bg with pasted instances appended.
    """
    fg_t = fg_example.get("targets")
    bg_t = bg_example.get("targets")
    if fg_t is None or bg_t is None or "masks" not in fg_t:
        return bg_example

    img = bg_example["image"].copy()
    h, w = img.shape[:2]
    mask_size = fg_t["masks"].shape[-1]
    scale_up = h // mask_size

    # existing foreground occupancy of the background
    bg_occupied = (bg_t["masks"][bg_t["valid"]].max(0) > 0.5 if bg_t["valid"].any()
                   else np.zeros((mask_size, mask_size), bool))

    fg_idx = np.nonzero(fg_t["valid"])[0]
    areas = fg_t["masks"][fg_idx].sum((1, 2))
    order = fg_idx[np.argsort(-areas)][:max_paste]

    out_t = {k: v.copy() for k, v in bg_t.items()}
    n_slots = out_t["valid"].shape[0]
    next_slot = int(out_t["valid"].sum())

    for i in order:
        if next_slot >= n_slots:
            break
        m_small = fg_t["masks"][i] > 0.5
        if not m_small.any():
            continue
        # avoid pasting onto existing foreground (reference: &~foreground_mask)
        m_small = m_small & ~bg_occupied
        if m_small.sum() < 4:
            continue
        m_full = resize_nearest(m_small.astype(np.uint8) * 255, h, w) > 127
        alpha = m_full.astype(np.float32)
        if m_full.sum() * (scale_up**2) >= blend_min_area and blend_sigma > 0:
            alpha = np.asarray(_blurred_mask((alpha * 255).astype(np.uint8), blend_sigma),
                               np.float32) / 255.0
            alpha = np.where(m_full, np.maximum(alpha, 0.5), np.minimum(alpha, 0.5))
        img = img * (1 - alpha[..., None]) + fg_example["image"] * alpha[..., None]

        ys, xs = np.nonzero(m_small)
        cx = (xs.min() + xs.max() + 1) / 2 / mask_size
        cy = (ys.min() + ys.max() + 1) / 2 / mask_size
        bw = (xs.max() + 1 - xs.min()) / mask_size
        bh = (ys.max() + 1 - ys.min()) / mask_size
        out_t["boxes"][next_slot] = [cx, cy, bw, bh]
        out_t["labels"][next_slot] = fg_t["labels"][i]
        out_t["masks"][next_slot] = m_small.astype(np.float32)
        out_t["valid"][next_slot] = True
        if "is_thing" in out_t:
            out_t["is_thing"][next_slot] = True
        bg_occupied |= m_small
        next_slot += 1

    out = dict(bg_example)
    out["image"] = img.astype(bg_example["image"].dtype)
    out["targets"] = out_t
    out["copypaste"] = 1
    return out


class CopyPasteMapper:
    """Wrap a base mapper, pairing each foreground sample with a background
    sample from a separate pool (MapDataset_coppaste semantics)."""

    def __init__(self, base_mapper, bg_dataset: List[dict], prob: float = 0.5, seed: int = 0):
        self.base = base_mapper
        self.bg_dataset = bg_dataset
        self.prob = prob
        self._rng = np.random.RandomState(seed)

    def __call__(self, record: Dict) -> Optional[Dict]:
        fg = self.base(record)
        if fg is None or self._rng.rand() > self.prob or not self.bg_dataset:
            return fg
        bg_rec = self.bg_dataset[self._rng.randint(len(self.bg_dataset))]
        bg = self.base(bg_rec)
        if bg is None:
            return fg
        return copypaste(fg, bg, self._rng)

    def get_state(self):
        """The generators' states: the copy-paste draws and the base mapper's."""
        return self._rng.get_state(), self.base._rng.get_state()

    def set_state(self, state) -> None:
        self._rng.set_state(state[0])
        self.base._rng.set_state(state[1])
