"""COCO/LVIS-format dataset registration, no pycocotools (counterpart of
``ape_tpu/data/datasets/coco.py``): the JSON loader (boxes xywh -> xyxy,
category ids to contiguous ids, the metadata from the JSON's categories),
``register_coco_instances`` and the federated loss's class weights from a
registered JSON. ``load_sem_seg`` and ``load_coco_panoptic`` wait (ROADMAP
Queue 1 #3).
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional

from ape_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger("ape_tpu_torch")


def load_coco_json(
    json_file: str,
    image_root: str,
    dataset_name: Optional[str] = None,
    extra_annotation_keys: Optional[List[str]] = None,
) -> List[dict]:
    """Parse a COCO-format json into detectron2-style dicts."""
    with open(json_file) as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    cat_ids = [c["id"] for c in cats]
    id_map = {cid: i for i, cid in enumerate(cat_ids)}
    thing_classes = [c.get("name", str(c["id"])) for c in cats]

    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.set(
            json_file=json_file,
            image_root=image_root,
            thing_classes=thing_classes,
            thing_dataset_id_to_contiguous_id=id_map,
        )

    anns_by_img = defaultdict(list)
    for ann in coco.get("annotations", []):
        anns_by_img[ann["image_id"]].append(ann)

    dicts = []
    extra = extra_annotation_keys or []
    for img in coco.get("images", []):
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
        }
        objs = []
        for ann in anns_by_img.get(img["id"], []):
            x, y, w, h = ann["bbox"]
            obj = {
                "bbox": [x, y, x + w, y + h],  # xyxy
                "category_id": id_map.get(ann["category_id"], 0),
                "iscrowd": ann.get("iscrowd", 0),
            }
            if "segmentation" in ann:
                obj["segmentation"] = ann["segmentation"]
            if "phrase" in ann:
                obj["phrase"] = ann["phrase"]
            for k in extra:
                if k in ann:
                    obj[k] = ann[k]
            objs.append(obj)
        record["annotations"] = objs
        dicts.append(record)
    logger.info(f"loaded {len(dicts)} images from {json_file}")
    return dicts


def register_coco_instances(name: str, metadata: Dict, json_file: str, image_root: str):
    """Equivalent of custom_register_coco_instances (ape/data/datasets/coco.py)."""
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="coco", **metadata
    )


def get_fed_loss_cls_weights(dataset_name: str, freq_weight_power: float = 0.5):
    """Per-class federated-loss weights from annotation frequency
    (reference ape/data/detection_utils.py:29-127 from *_cat_info.json)."""
    import numpy as np

    meta = MetadataCatalog.get(dataset_name)
    json_file = meta.get("json_file")
    with open(json_file) as f:
        coco = json.load(f)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    counts = np.zeros(len(cats))
    if all("image_count" in c for c in cats):
        for c in cats:
            counts[id_map[c["id"]]] = c["image_count"]
    else:
        for ann in coco.get("annotations", []):
            if ann["category_id"] in id_map:
                counts[id_map[ann["category_id"]]] += 1
    return counts**freq_weight_power
