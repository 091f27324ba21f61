"""The panoptic mapper (counterpart of ``ape_tpu/data/mapper_panoptic.py``):
read the panoptic PNG (id = R + 256 G + 256^2 B, through ``read_rgb``),
turn each segment of ``segments_info`` into an instance with its mask:
things as they are, stuff with ``stuff_classes_offset`` added to its class
and ``is_thing`` False, split into its 4-connected components when
``stuff_classes_decomposition`` is set; then map as the instance mapper
does.

``connected_components`` gives JAX's breadth-first flood fill's list (one
mask a component, in the raster order of each component's first pixel) from
``scipy.ndimage.label``'s labelling, without a Python loop over pixels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ape_tpu_torch.data.image_io import read_rgb
from ape_tpu_torch.data.mapper import DatasetMapperDETR


def rgb2id(color: np.ndarray) -> np.ndarray:
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def connected_components(mask: np.ndarray) -> List[np.ndarray]:
    """The 4-connected components of ``mask`` (H, W) bool, one (H, W) bool
    mask each, ordered by each component's first pixel in raster order."""
    from scipy import ndimage

    labels, n = ndimage.label(mask)
    flat = labels.ravel()
    _, first = np.unique(flat, return_index=True)  # first raster index of 0, 1, ..., n
    order = np.argsort(first[1:], kind="stable") + 1
    return [labels == k for k in order]


@dataclasses.dataclass
class DatasetMapperPanoptic(DatasetMapperDETR):
    stuff_classes_offset: int = 0
    stuff_classes_decomposition: bool = False

    def __call__(self, record: Dict) -> Optional[Dict]:
        if "pan_seg_file_name" not in record:
            return super().__call__(record)
        pan = rgb2id(read_rgb(record["pan_seg_file_name"]))
        anns = list(record.get("annotations", []))
        for seg in record.get("segments_info", []):
            m = pan == seg["id"]
            if not m.any():
                continue
            if seg.get("isthing", True):
                parts = [m]
                cat = seg["category_id"]
                is_thing = True
            else:
                parts = connected_components(m) if self.stuff_classes_decomposition else [m]
                cat = seg["category_id"] + self.stuff_classes_offset
                is_thing = False
            for p in parts:
                ys, xs = np.nonzero(p)
                anns.append(
                    {
                        "bbox": [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                        "category_id": cat,
                        "_mask": p,
                        "is_thing": is_thing,
                        "iscrowd": 0,
                    }
                )
        return super().__call__(dict(record, annotations=anns))
