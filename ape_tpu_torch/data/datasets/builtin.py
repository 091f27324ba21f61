"""Builtin dataset registrations under ``$DETECTRON2_DATASETS`` (a copy of
``ape_tpu/data/datasets/builtin.py``): the COCO-style, panoptic and semantic
tables of names, relative paths and evaluator types (the reference's ~25
registration modules: COCO, LVIS, Objects365, OpenImages, Visual Genome,
SA-1B, RefCOCO, GQA, PhraseCut, Flickr30k, GRiT, D-cube, ODinW, SegInW,
Roboflow-100, ADE20k, BDD, Cityscapes, Pascal Context and VOC), with the
split tables of ``metadata``'s assets.

``register_metadata`` fills the ``MetadataCatalog`` for every builtin name
(classes, prompts, fed-loss counts, evaluator type) without any file;
``register_all`` adds to the ``DatasetCatalog`` each dataset whose
annotation file or directory exists under the root, skipping names already
registered. Both run at import, the root read from ``DETECTRON2_DATASETS``
then (default ``datasets``), as JAX's module does; call ``register_all(root)``
to register another root later.
"""

from __future__ import annotations

import logging
import os

from ape_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from ape_tpu_torch.data.datasets import metadata as M
from ape_tpu_torch.data.datasets.coco import (
    register_coco_instances,
    register_coco_panoptic,
    register_sem_seg,
)

logger = logging.getLogger("ape_tpu_torch")

_ROOT = os.environ.get("DETECTRON2_DATASETS", "datasets")

# name -> (annotation json, image root, evaluator_type), reference conventions
_COCO_STYLE = {
    # COCO (coco.py)
    "coco_2017_train": ("coco/annotations/instances_train2017.json", "coco/train2017", "coco"),
    "coco_2017_val": ("coco/annotations/instances_val2017.json", "coco/val2017", "coco"),
    # LVIS (lvis.py, lvis_coco.py)
    "lvis_v1_train": ("lvis/lvis_v1_train.json", "coco", "lvis"),
    "lvis_v1_val": ("lvis/lvis_v1_val.json", "coco", "lvis"),
    "lvis_v1_minival": ("lvis/lvis_v1_minival.json", "coco", "lvis"),
    "lvis_v1_train+coco": ("lvis/lvis_v1_train+coco.json", "coco", "lvis"),
    # COCO-Stuff panoptic stuff-only group (lvis_coco_panoptic.py)
    "coco_2017_train_panoptic_stuffonly": (
        "coco/annotations/panoptic_train2017_stuffonly.json", "coco/train2017", "sem_seg"
    ),
    # Visual Genome (visualgenome.py)
    "visualgenome_train_box": ("visualgenome/annotations/train.json", "visualgenome/images", "coco"),
    "visualgenome_train_region": ("visualgenome/annotations/train_region.json", "visualgenome/images", "coco"),
    "visualgenome_77962_box_and_region": (
        "visualgenome/annotations/visualgenome_77962_box_and_region.json", "visualgenome/images", "coco"
    ),
    # SA-1B splits (sa1b.py)
    "sa1b_1m": ("sa1b/annotations/sa1b_1m.json", "sa1b/images", "coco"),
    "sa1b_2m": ("sa1b/annotations/sa1b_2m.json", "sa1b/images", "coco"),
    # RefCOCO family (refcoco.py)
    "refcoco-mixed_group-by-image": ("refcoco/annotations/refcoco-mixed_group-by-image.json", "coco/train2014", "refcoco"),
    "refcoco-unc-val": ("refcoco/annotations/refcoco-unc-val.json", "coco/train2014", "refcoco"),
    "refcoco-unc-testA": ("refcoco/annotations/refcoco-unc-testA.json", "coco/train2014", "refcoco"),
    "refcoco-unc-testB": ("refcoco/annotations/refcoco-unc-testB.json", "coco/train2014", "refcoco"),
    "refcocoplus-unc-val": ("refcoco/annotations/refcocoplus-unc-val.json", "coco/train2014", "refcoco"),
    "refcocoplus-unc-testA": ("refcoco/annotations/refcocoplus-unc-testA.json", "coco/train2014", "refcoco"),
    "refcocoplus-unc-testB": ("refcoco/annotations/refcocoplus-unc-testB.json", "coco/train2014", "refcoco"),
    "refcocog-umd-val": ("refcoco/annotations/refcocog-umd-val.json", "coco/train2014", "refcoco"),
    "refcocog-umd-test": ("refcoco/annotations/refcocog-umd-test.json", "coco/train2014", "refcoco"),
    # GQA / PhraseCut / Flickr30k / GRiT
    "gqa_region_train": ("gqa/annotations/train_region.json", "gqa/images", "coco"),
    "gqa_region_val": ("gqa/annotations/val_region.json", "gqa/images", "refcoco"),
    "phrasecut_train": ("phrasecut/annotations/train.json", "phrasecut/images", "coco"),
    "phrasecut_val": ("phrasecut/annotations/val.json", "phrasecut/images", "refcoco"),
    "flickr30k_separateGT_train": ("flickr30k/annotations/final_flickr_separateGT_train.json", "flickr30k/images", "coco"),
    "flickr30k_separateGT_val": ("flickr30k/annotations/final_flickr_separateGT_val.json", "flickr30k/images", "refcoco"),
    "flickr30k_separateGT_test": ("flickr30k/annotations/final_flickr_separateGT_test.json", "flickr30k/images", "refcoco"),
    "grit_5m": ("grit/annotations/grit_5m.json", "grit/images", "coco"),
    "grit": ("grit/annotations/grit.json", "grit/images", "coco"),
    # reference data configs also name the full/4m+ SA-1B splits and the
    # non-grouped refcoco-mixed (refcoco.py:311, sa1b.py:21-27)
    "sa1b": ("sa1b/annotations/sa1b.json", "sa1b/images", "coco"),
    "sa1b_4m": ("sa1b/annotations/sa1b_4m.json", "sa1b/images", "coco"),
    "sa1b_6m": ("sa1b/annotations/sa1b_6m.json", "sa1b/images", "coco"),
    "sa1b_8m": ("sa1b/annotations/sa1b_8m.json", "sa1b/images", "coco"),
    "sa1b_10m": ("sa1b/annotations/sa1b_10m.json", "sa1b/images", "coco"),
    "refcoco-mixed": ("refcoco/annotations/refcoco-mixed.json", "coco/train2014", "refcoco"),
    "visualgenome_150_box_val": (
        "visualgenome/annotations/visualgenome_150_box_val.json", "visualgenome/images", "coco"
    ),
    "visualgenome_region_val": ("visualgenome/annotations/val_region.json", "visualgenome/images", "refcoco"),
    # COCO-Stuff semantic eval via the panoptic stuff-only group
    "coco_2017_val_panoptic_stuffonly": (
        "coco/annotations/panoptic_val2017_stuffonly.json", "coco/val2017", "sem_seg"
    ),
}

ODINW_13 = [
    "AerialMaritimeDrone", "Aquarium", "CottontailRabbits", "EgoHands",
    "NorthAmericaMushrooms", "Packages", "PascalVOC", "Raccoon", "ShellfishOpenImages",
    "VehiclesOpenImages", "pistols", "pothole", "thermalDogsAndPeople",
]

# the ODinW-13 eval split names exactly as the reference evaluates them
# (configs/common/data/odinw13_instance_lsj1024.py:88-102 — _test splits,
# PascalVOC on _val)
ODINW_13_TEST = [
    "odinw_AerialMaritimeDrone_large_test",
    "odinw_Aquarium_Aquarium_Combined.v2-raw-1024.coco_test",
    "odinw_CottontailRabbits_test",
    "odinw_EgoHands_generic_test",
    "odinw_NorthAmericaMushrooms_North_American_Mushrooms.v1-416x416.coco_test",
    "odinw_Packages_Raw_test",
    "odinw_PascalVOC_val",
    "odinw_pistols_export_test",
    "odinw_pothole_test",
    "odinw_Raccoon_Raccoon.v2-raw.coco_test",
    "odinw_ShellfishOpenImages_raw_test",
    "odinw_thermalDogsAndPeople_test",
    "odinw_VehiclesOpenImages_416x416_test",
]

# panoptic datasets: name -> (panoptic json, image root, panoptic png root)
# (reference registers these via detectron2 register_coco_panoptic; the eval
# task dirs COCO/ADE20k/BDD10k/Cityscapes/PascalVOCParts_PanopticSegmentation)
_PANOPTIC = {
    "coco_2017_train_panoptic": (
        "coco/annotations/panoptic_train2017.json", "coco/train2017", "coco/panoptic_train2017"
    ),
    "coco_2017_val_panoptic": (
        "coco/annotations/panoptic_val2017.json", "coco/val2017", "coco/panoptic_val2017"
    ),
    "ade20k_panoptic_train": (
        "ADEChallengeData2016/ade20k_panoptic_train.json",
        "ADEChallengeData2016/images/training",
        "ADEChallengeData2016/ade20k_panoptic_train",
    ),
    "ade20k_panoptic_val": (
        "ADEChallengeData2016/ade20k_panoptic_val.json",
        "ADEChallengeData2016/images/validation",
        "ADEChallengeData2016/ade20k_panoptic_val",
    ),
    "cityscapes_fine_panoptic_train": (
        "cityscapes/gtFine/cityscapes_panoptic_train.json",
        "cityscapes/leftImg8bit/train",
        "cityscapes/gtFine/cityscapes_panoptic_train",
    ),
    "pascalvocpart_train": (
        "VOCdevkit/VOC2010/pascal_parts_panoptic_train.json",
        "VOCdevkit/VOC2010/JPEGImages",
        "VOCdevkit/VOC2010/pascal_parts_panoptic_train",
    ),
    "bdd10k_40_panoptic_val": (
        "bdd100k/labels/pan_seg/panoptic_val.json",
        "bdd100k/images/10k/val",
        "bdd100k/labels/pan_seg/bitmasks/val",
    ),
    "cityscapes_fine_panoptic_val": (
        "cityscapes/gtFine/cityscapes_panoptic_val.json",
        "cityscapes/leftImg8bit/val",
        "cityscapes/gtFine/cityscapes_panoptic_val",
    ),
    "pascal_parts_panoptic_val": (
        "VOCdevkit/VOC2010/pascal_parts_panoptic_val.json",
        "VOCdevkit/VOC2010/JPEGImages",
        "VOCdevkit/VOC2010/pascal_parts_panoptic_val",
    ),
}

# semantic segmentation datasets (ade20k, pascal context, voc, bdd, cityscapes)
_SEM_SEG = {
    # train splits (the *_SemanticSegmentation training configs)
    "ade20k_sem_seg_train": ("ADEChallengeData2016/annotations_detectron2/training", "ADEChallengeData2016/images/training"),
    "ade20k_full_sem_seg_train": ("ADE20K_2021_17_01/annotations_detectron2/training", "ADE20K_2021_17_01/images/training"),
    "cityscapes_fine_sem_seg_train": ("cityscapes/gtFine/cityscapes_panoptic_train", "cityscapes/leftImg8bit/train"),
    "bdd10k_sem_seg_train": ("bdd100k/labels/sem_seg/masks/train", "bdd100k/images/10k/train"),
    # reference-name aliases (bdd10k_semantic_lsj1024.py names it
    # bdd10k_val_sem_seg; pascalvoc20_semantic_lsj1024.py pascalvoc20_…)
    "bdd10k_val_sem_seg": ("bdd100k/labels/sem_seg/masks/val", "bdd100k/images/10k/val"),
    "pascalvoc20_sem_seg_val": ("VOCdevkit/VOC2012/annotations_detectron2/val", "VOCdevkit/VOC2012/JPEGImages"),
    "ade20k_sem_seg_val": ("ADEChallengeData2016/annotations_detectron2/validation", "ADEChallengeData2016/images/validation"),
    "ade20k_full_sem_seg_val": ("ADE20K_2021_17_01/annotations_detectron2/validation", "ADE20K_2021_17_01/images/validation"),
    "pascal_context_59_sem_seg_val": ("VOCdevkit/VOC2010/annotations_detectron2/pc59_val", "VOCdevkit/VOC2010/JPEGImages"),
    "pascal_context_459_sem_seg_val": ("VOCdevkit/VOC2010/annotations_detectron2/pc459_val", "VOCdevkit/VOC2010/JPEGImages"),
    "pascal_voc_20_sem_seg_val": ("VOCdevkit/VOC2012/annotations_detectron2/val", "VOCdevkit/VOC2012/JPEGImages"),
    "bdd10k_sem_seg_val": ("bdd100k/labels/sem_seg/masks/val", "bdd100k/images/10k/val"),
    "cityscapes_fine_sem_seg_val": ("cityscapes/gtFine/cityscapes_panoptic_val", "cityscapes/leftImg8bit/val"),
}


def _set_meta(name: str, **kwargs):
    MetadataCatalog.get(name).set(**{k: v for k, v in kwargs.items() if v is not None})


def _maybe_register(name: str, json_rel: str, img_rel: str, root: str) -> int:
    if name in DatasetCatalog:
        return 0
    jp = os.path.join(root, json_rel)
    if not os.path.exists(jp):
        return 0
    register_coco_instances(name, {}, jp, os.path.join(root, img_rel))
    return 1


def register_metadata():
    """Populate MetadataCatalog for every builtin name (no files needed)."""
    # Objects365 (fixname variants use the corrected names)
    o365 = [c["name"] for c in M.objects365_categories(fixname=True)]
    for key in M.objects365_splits():
        _set_meta(key, thing_classes=o365, evaluator_type="coco")

    # OpenImages: v6 categories + hierarchical evaluator + fed-loss counts
    oid_v6 = [c["name"] for c in M.oid_categories("v6")]
    oid_2019 = [c["name"] for c in M.oid_categories("2019")]
    counts = M.category_image_counts("openimages")
    splits = M.oid_splits()
    for key in splits.get("_PREDEFINED_SPLITS_OPENIMAGES_V6_DETECTION", {}):
        _set_meta(key, thing_classes=oid_v6, evaluator_type="oid",
                  category_image_counts=counts)
    for key in splits.get("_PREDEFINED_SPLITS_OPENIMAGES_DETECTION", {}):
        _set_meta(key, thing_classes=oid_2019, evaluator_type="oid")
    for key in splits.get("_PREDEFINED_SPLITS_OID", {}):
        _set_meta(key, thing_classes=oid_2019, evaluator_type="oid")
    for key in splits.get("_PREDEFINED_SPLITS_OID_SEG", {}):
        _set_meta(key, thing_classes=[c["name"] for c in M.oid_categories("seg")],
                  evaluator_type="oid")

    # ODinW 35: per-dataset classes with prompt rewording
    for group, per_split in M.odinw_splits().items():
        ds = group.split("odinw_", 1)[1]
        base = ds.split("_")[0] if ds.split("_")[0] in M.odinw_categories() else ds
        try:
            classes = M.thing_classes_with_prompts(base)
        except KeyError:
            classes = None
        for key in per_split:
            _set_meta(key, thing_classes=classes, evaluator_type="coco")

    # SegInW 25
    segc = M.seginw_categories()
    for key in M.seginw_splits():
        ds = key.split("seginw_", 1)[1].rsplit("_", 1)[0]
        cats = segc.get(ds)
        _set_meta(key, thing_classes=[c["name"] for c in cats] if cats else None,
                  evaluator_type="coco")

    # LVIS fed-loss counts
    lvis_counts = M.category_image_counts("lvis")
    for key in ("lvis_v1_train", "lvis_v1_val", "lvis_v1_minival", "lvis_v1_train+coco"):
        _set_meta(key, category_image_counts=lvis_counts, evaluator_type="lvis")

    # COCO thing/stuff metadata from the inst_categories table
    coco_things = [c["name"] for c in M.inst_categories("coco")]
    for key in ("coco_2017_train", "coco_2017_val"):
        _set_meta(key, thing_classes=coco_things, evaluator_type="coco")

    # D-cube
    for group_name, group in M.d3_splits().items():
        for key in group:
            _set_meta(
                key,
                evaluator_type="d3",
                d3_group="intra" if "intra" in group_name else "inter",
            )

    # refcoco family
    for key, (_, _, et) in _COCO_STYLE.items():
        if et != "coco":
            _set_meta(key, evaluator_type=et)
    for key in _SEM_SEG:
        _set_meta(key, evaluator_type="sem_seg")
    for key in _PANOPTIC:
        _set_meta(key, evaluator_type="panoptic")


def register_all(root: str = _ROOT) -> int:
    """Register every builtin dataset whose files exist. Returns the count."""
    register_metadata()
    n = 0
    for name, (json_rel, img_rel, _et) in _COCO_STYLE.items():
        n += _maybe_register(name, json_rel, img_rel, root)

    # Objects365 / OID / D3 split tables (reference path conventions)
    for key, (img_rel, json_rel) in M.objects365_splits().items():
        n += _maybe_register(key, json_rel, img_rel, root)
    for table in M.oid_splits().values():
        for key, (img_rel, json_rel) in table.items():
            n += _maybe_register(key, json_rel, img_rel, root)
    # D-cube: {group: {name: [img_root, {FULL/PRES/ABS: json}, pkl_root]}}
    for group in M.d3_splits().values():
        for key, spec in group.items():
            img_rel, jsons = spec[0], spec[1]
            n += _maybe_register(key, jsons["FULL"], img_rel, root)

    # ODinW 35 (odinw_instance.py split table)
    for group, per_split in M.odinw_splits().items():
        for key, (img_rel, json_rel) in per_split.items():
            n += _maybe_register(key, json_rel, img_rel, root)

    # SegInW 25
    for key, (split, base_rel, ann_name) in M.seginw_splits().items():
        n += _maybe_register(
            key, os.path.join(base_rel, split, ann_name), os.path.join(base_rel, split), root
        )

    # Roboflow-100: discovered by directory scan (reference
    # configs/common/data/roboflow100_instance_lsj1024.py:15-28)
    rf_root = os.path.join(root, "rf100")
    if os.path.isdir(rf_root):
        for d in sorted(os.listdir(rf_root)):
            key = f"rf100_{d}_test"
            jp = os.path.join("rf100", d, "test", "_annotations.coco.json")
            got = _maybe_register(key, jp, os.path.join("rf100", d, "test"), root)
            if got:
                _set_meta(key, evaluator_type="coco")
            n += got

    for name, (gt_rel, img_rel) in _SEM_SEG.items():
        if name in DatasetCatalog:
            continue
        gp = os.path.join(root, gt_rel)
        if os.path.isdir(gp):
            register_sem_seg(name, {}, gp, os.path.join(root, img_rel))
            n += 1

    for name, (json_rel, img_rel, pan_rel) in _PANOPTIC.items():
        if name in DatasetCatalog:
            continue
        jp = os.path.join(root, json_rel)
        if os.path.exists(jp):
            register_coco_panoptic(
                name, {}, jp, os.path.join(root, img_rel), os.path.join(root, pan_rel)
            )
            n += 1
    if n:
        logger.info(f"registered {n} builtin datasets under {root}")
    return n


# auto-register at import (reference convention: each dataset module bottom)
register_all()
