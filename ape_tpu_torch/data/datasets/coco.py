"""COCO/LVIS-format dataset registration, no pycocotools (counterpart of
``ape_tpu/data/datasets/coco.py``): the JSON loader (boxes xywh -> xyxy,
category ids to contiguous ids, the metadata from the JSON's categories),
``register_coco_instances``, the semantic loader (label PNGs paired with
images by name) and the COCO panoptic loader (a panoptic JSON's
``segments_info`` and the path of each image's RGB-coded id PNG) with their
registrations, and the federated loss's class weights from a registered
JSON.
"""

from __future__ import annotations

import glob
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


def load_sem_seg(gt_root: str, image_root: str, gt_ext=".png", image_ext=".jpg"):
    """Semantic segmentation dataset loader (detectron2 load_sem_seg semantics)."""
    gt_files = sorted(glob.glob(os.path.join(gt_root, "*" + gt_ext)))
    dicts = []
    for g in gt_files:
        base = os.path.splitext(os.path.basename(g))[0]
        dicts.append(
            {
                "file_name": os.path.join(image_root, base + image_ext),
                "sem_seg_file_name": g,
            }
        )
    return dicts


def register_sem_seg(name: str, metadata: Dict, gt_root: str, image_root: str):
    DatasetCatalog.register(name, lambda: load_sem_seg(gt_root, image_root))
    MetadataCatalog.get(name).set(
        evaluator_type="sem_seg", gt_root=gt_root, image_root=image_root, **metadata
    )


def load_coco_panoptic(json_file: str, image_root: str, pan_seg_root: str):
    """COCO panoptic format loader (detectron2 register_coco_panoptic semantics:
    panoptic json with per-image segments_info + RGB-encoded id PNGs)."""
    with open(json_file) as f:
        pan = json.load(f)
    images = {im["id"]: im for im in pan.get("images", [])}
    dicts = []
    skipped = 0
    for ann in pan.get("annotations", []):
        im = images.get(ann["image_id"])
        if im is None:
            # a record with height/width None and a guessed file name only
            # fails later with a cryptic mapper error — skip it loudly here
            skipped += 1
            continue
        fname = im.get("file_name", ann["file_name"].replace(".png", ".jpg"))
        dicts.append(
            {
                "file_name": os.path.join(image_root, fname),
                "image_id": ann["image_id"],
                "height": im.get("height"),
                "width": im.get("width"),
                "pan_seg_file_name": os.path.join(pan_seg_root, ann["file_name"]),
                "segments_info": ann["segments_info"],
            }
        )
    if skipped:
        logger.warning(
            f"{json_file}: {skipped} annotations reference image_ids missing "
            "from the images table; skipped"
        )
    logger.info(f"loaded {len(dicts)} panoptic images from {json_file}")
    return dicts


def register_coco_panoptic(
    name: str, metadata: Dict, json_file: str, image_root: str, pan_seg_root: str
):
    """Equivalent of detectron2 register_coco_panoptic used by the reference's
    panoptic configs (ape/data/datasets/coco_panoptic.py conventions)."""
    DatasetCatalog.register(
        name, lambda: load_coco_panoptic(json_file, image_root, pan_seg_root)
    )
    MetadataCatalog.get(name).set(
        evaluator_type="panoptic",
        json_file=json_file,
        image_root=image_root,
        pan_seg_root=pan_seg_root,
        **metadata,
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
