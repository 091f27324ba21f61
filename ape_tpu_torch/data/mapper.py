"""The instance mapper: raw dataset dict -> fixed-shape example (counterpart
of ``ape_tpu/data/mapper.py``'s ``DatasetMapperDETR``): read the image, LSJ
in training or the shortest-edge resize and pad in evaluation, and in
training the instances (boxes, classes, masks at ``mask_size``, phrases)
padded to ``max_gt`` with a validity mask. The record's draws come from the
mapper's seeded ``np.random.RandomState`` in JAX's order (scale, flip, crop
row, crop column), and every resize and rasterization is PIL's bit for bit
(``data.transforms``), so an example equals JAX's for the same record and
seed. ``DatasetMapperSemantic`` turns each class of a semantic label map
(``read_label_map``: palette indices, not colours) into a stuff instance
with its mask, then maps as the instance mapper does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ape_tpu_torch.data.image_io import read_image, read_label_map
from ape_tpu_torch.data.transforms import (
    TransformRecord,
    apply_to_boxes,
    apply_to_mask,
    lsj_transform,
    pad_to_square,
    polygons_to_mask,
    resize_nearest,
    resize_shortest_edge,
    rle_decode,
)

# pixel stats (reference base config: model pixel_mean/std, RGB)
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _ann_to_mask(ann: Dict, h: int, w: int) -> Optional[np.ndarray]:
    if "_mask" in ann:  # pre-rasterized (semantic mapper stuff regions)
        return ann["_mask"]
    seg = ann.get("segmentation")
    if seg is None:
        return None
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict):
        return rle_decode(seg, h, w)
    return None


@dataclasses.dataclass
class DatasetMapperDETR:
    """Training mapper with LSJ; is_train=False applies test-time resize."""

    is_train: bool = True
    image_size: int = 1024
    max_gt: int = 100
    mask_on: bool = True
    mask_size: int = 256  # mask-loss grid (image_size // 4)
    min_scale: float = 0.1
    max_scale: float = 2.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)

    def __call__(self, record: Dict) -> Optional[Dict]:
        img = read_image(record["file_name"]) if "file_name" in record else record.get("image")
        if img is None:
            return None
        h0, w0 = img.shape[:2]

        if self.is_train:
            canvas, rec = lsj_transform(
                img, self._rng, self.image_size, self.min_scale, self.max_scale
            )
        else:
            resized, r = resize_shortest_edge(img, self.image_size, self.image_size)
            canvas, (vh, vw) = pad_to_square(resized, self.image_size)
            rec = TransformRecord(r, False, (0, 0), (self.image_size,) * 2, (vh, vw))

        image = (canvas.astype(np.float32) - PIXEL_MEAN) / PIXEL_STD

        out = {
            "image": image,
            "image_size": np.asarray(rec.valid_size, np.int32),
            "height": h0,
            "width": w0,
            "image_id": record.get("image_id", 0),
            "transform": rec,
        }
        if not self.is_train:
            return out

        anns = [a for a in record.get("annotations", []) if a.get("iscrowd", 0) == 0]
        boxes = np.zeros((self.max_gt, 4), np.float32)
        labels = np.zeros((self.max_gt,), np.int32)
        valid = np.zeros((self.max_gt,), bool)
        is_thing = np.ones((self.max_gt,), bool)
        masks = (
            np.zeros((self.max_gt, self.mask_size, self.mask_size), np.float32)
            if self.mask_on
            else None
        )
        phrases: List[str] = []

        kept = 0
        for ann in anns:
            if kept >= self.max_gt:
                break
            b = apply_to_boxes(np.asarray([ann["bbox"]], np.float32), rec, w0)[0]
            bw, bh = b[2] - b[0], b[3] - b[1]
            if bw <= 1 or bh <= 1:  # filter empty (cropped-out) boxes
                continue
            m_small = None
            if self.mask_on:
                m = _ann_to_mask(ann, h0, w0)
                if m is not None:
                    m_canvas = apply_to_mask(m, rec)
                    if not m_canvas.any():
                        continue
                    m_small = (
                        resize_nearest(
                            m_canvas.astype(np.uint8) * 255,
                            self.mask_size,
                            self.mask_size,
                        )
                        > 127
                    )
            cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
            boxes[kept] = [
                cx / self.image_size,
                cy / self.image_size,
                bw / self.image_size,
                bh / self.image_size,
            ]
            labels[kept] = ann.get("category_id", 0)
            is_thing[kept] = ann.get("is_thing", True)
            if masks is not None and m_small is not None:
                masks[kept] = m_small
            valid[kept] = True
            phrases.append(ann.get("phrase", ""))
            kept += 1

        out["targets"] = {
            "labels": labels,
            "boxes": boxes,
            "valid": valid,
            "is_thing": is_thing,
        }
        if masks is not None:
            out["targets"]["masks"] = masks
        out["phrases"] = phrases
        return out


@dataclasses.dataclass
class DatasetMapperSemantic(DatasetMapperDETR):
    """Semantic variant: stuff regions become instances with masks
    (DatasetMapper_detr_semantic behavior)."""

    ignore_label: int = 255

    def __call__(self, record: Dict) -> Optional[Dict]:
        if "sem_seg_file_name" not in record:
            return super().__call__(record)
        img = read_image(record["file_name"])
        if img is None:
            return None
        sem = read_label_map(record["sem_seg_file_name"])
        anns = []
        for cls in np.unique(sem):
            if cls == self.ignore_label:
                continue
            m = sem == cls
            ys, xs = np.nonzero(m)
            anns.append(
                {
                    "bbox": [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                    "category_id": int(cls),
                    "segmentation": None,
                    "_mask": m,
                    "is_thing": False,
                }
            )
        rec2 = dict(record, annotations=anns)
        return super().__call__(rec2)
