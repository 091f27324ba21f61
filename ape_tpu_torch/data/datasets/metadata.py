"""Category, prompt, split and count tables of the builtin datasets (a copy
of ``ape_tpu/data/datasets/metadata.py``). The tables are the JAX
package's JSON assets, copied into ``assets/``: ODinW's categories, prompt
rewordings and splits, SegInW's, Objects365's, OpenImages' (v6, the 2019
challenge and the segmentation set), D-cube's splits, the per-dataset
``inst_categories``, and LVIS v1's and OpenImages v6's per-category image
counts, from which the federated loss takes its class weights. Each file is
parsed on first use and cached.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, List, Optional

_ASSETS = Path(__file__).resolve().parent / "assets"


@functools.lru_cache(maxsize=None)
def _load(name: str):
    with open(_ASSETS / name) as f:
        return json.load(f)


def odinw_categories() -> Dict[str, List[dict]]:
    return _load("odinw_categories.json")["ODINW_CATEGORIES"]


def odinw_prompts() -> Dict[str, Dict[str, str]]:
    """Static name->prompt maps (reference odinw_prompts.py lambdas applied)."""
    return _load("odinw_prompts.json")


def odinw_splits() -> Dict[str, Dict[str, list]]:
    return _load("odinw_splits.json")


def seginw_categories() -> Dict[str, List[dict]]:
    return _load("seginw_categories.json")["SEGINW_CATEGORIES"]


def seginw_splits() -> Dict[str, list]:
    return _load("seginw_splits.json")


def objects365_categories(fixname: bool = True) -> List[dict]:
    key = "OBJECTS365_CATEGORIES_FIXNAME" if fixname else "OBJECTS365_CATEGORIES"
    return _load("objects365_categories.json")[key]


def objects365_splits() -> Dict[str, list]:
    return _load("objects365_splits.json")


def oid_categories(version: str = "v6") -> List[dict]:
    d = _load("oid_categories.json")
    return {
        "2019": d["OPENIMAGES_2019_CATEGORIES"],
        "v6": d["OPENIMAGES_V6_CATEGORIES"],
        "seg": d["categories_seg"],
    }[version]


def oid_splits() -> Dict[str, Dict[str, list]]:
    return _load("oid_splits.json")


def d3_splits() -> Dict[str, list]:
    return _load("d3_splits.json")


def inst_categories(dataset: str) -> List[dict]:
    """Per-meta-dataset category tables (coco/cityscapes/mapillary/oid/...)."""
    return _load("inst_categories.json")[dataset]


def category_image_counts(dataset: str) -> Optional[Dict[int, int]]:
    """Per-category image counts for federated loss / LVIS r-c-f buckets:
    LVIS v1's for names starting ``lvis``, OpenImages v6's for ``openimages``
    and ``oid``, else None."""
    if dataset.startswith("lvis"):
        rows = _load("lvis_v1_coco_category_image_count.json")[
            "LVIS_V1_COCO_CATEGORY_IMAGE_COUNT"
        ]
    elif dataset.startswith("openimages") or dataset.startswith("oid"):
        rows = _load("openimages_v6_category_image_count.json")[
            "OPENIMAGES_V6_CATEGORY_IMAGE_COUNT"
        ]
    else:
        return None
    return {int(r["id"]): int(r["image_count"]) for r in rows}


def fed_loss_cls_weights(dataset: str, freq_weight_power: float = 0.5) -> Optional[List[float]]:
    """count^power weights, ordered by category id (reference
    ape/data/detection_utils.py:29-127 get_fed_loss_cls_weights); None for a
    dataset without a count table."""
    counts = category_image_counts(dataset)
    if counts is None:
        return None
    ids = sorted(counts)
    return [counts[i] ** freq_weight_power for i in ids]


def thing_classes_with_prompts(odinw_dataset: str) -> List[str]:
    """ODinW vocabulary with per-dataset prompt rewording applied
    (reference odinw_instance.py::_get_builtin_metadata)."""
    cats = odinw_categories()[odinw_dataset]
    pmap = odinw_prompts().get(odinw_dataset, {})
    return [pmap.get(c["name"], c["name"]) for c in cats]
