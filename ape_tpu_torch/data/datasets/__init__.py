from .coco import get_fed_loss_cls_weights, load_coco_json, register_coco_instances

__all__ = ["get_fed_loss_cls_weights", "load_coco_json", "register_coco_instances"]
