"""Dataset metadata the port reads (counterpart of
``ape_tpu/data/datasets/metadata.py``): LVIS v1's per-category image counts
(``assets/lvis_v1_coco_category_image_count.json``, a copy of the JAX
package's asset) and the federated loss's class weights from them, and
SegInW's category tables, which the SegInW data configs read at load time.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, List

_ASSETS = Path(__file__).resolve().parent / "assets"


@functools.lru_cache(maxsize=None)
def lvis_category_image_counts() -> Dict[int, int]:
    """{LVIS v1 category id: the number of train images it appears in}."""
    with open(_ASSETS / "lvis_v1_coco_category_image_count.json") as f:
        rows = json.load(f)["LVIS_V1_COCO_CATEGORY_IMAGE_COUNT"]
    return {int(r["id"]): int(r["image_count"]) for r in rows}


def fed_loss_cls_weights(dataset: str, freq_weight_power: float = 0.5) -> List[float]:
    """count ^ power per class, ordered by category id (JAX's
    ``fed_loss_cls_weights``; the reference's ``get_fed_loss_cls_weights``).
    The port keeps LVIS's counts only."""
    if not dataset.startswith("lvis"):
        raise ValueError(f"{dataset!r}: the port keeps the category image counts of LVIS only")
    counts = lvis_category_image_counts()
    return [counts[i] ** freq_weight_power for i in sorted(counts)]


@functools.lru_cache(maxsize=None)
def _seginw() -> dict:
    with open(_ASSETS / "seginw_categories.json") as f:
        return json.load(f)


def seginw_categories() -> Dict[str, List[dict]]:
    """SegInW's category tables by dataset (``assets/seginw_categories.json``,
    a copy of the JAX package's asset), as the SegInW data configs read them
    at load time."""
    return _seginw()["SEGINW_CATEGORIES"]
