from . import builtin  # auto-registers datasets under $DETECTRON2_DATASETS
from .coco import (
    get_fed_loss_cls_weights,
    load_coco_json,
    load_coco_panoptic,
    load_sem_seg,
    register_coco_instances,
    register_coco_panoptic,
    register_sem_seg,
)

__all__ = ["builtin", "get_fed_loss_cls_weights", "load_coco_json", "load_coco_panoptic",
           "load_sem_seg", "register_coco_instances", "register_coco_panoptic",
           "register_sem_seg"]
