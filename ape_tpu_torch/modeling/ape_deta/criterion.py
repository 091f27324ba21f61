"""DETA criterion for detection (counterpart of
``ape_tpu/modeling/ape_deta/criterion.py``), losses ``("class", "boxes")``:

  * focal class loss over the text columns, L1 + GIoU box losses;
  * stage2 assignment against the detached initial references, shared by the
    final and the auxiliary decoder layers;
  * stage1 assignment on the binary encoder proposals against their anchors;
  * ``total`` weighs every term by ``weight_dict`` with the ``_{i}`` and
    ``_enc`` suffixes fanned out to their base name.

The outputs the losses read are cast to f32 first (the model may compute in
bf16).
Targets are fixed-shape padded tensors: labels (B, G) int, boxes (B, G, 4)
cxcywh in [0, 1], valid (B, G) bool.

Not ported yet: the federated class subset, the mask losses, the
``pred_iou`` / ``anchor_iou`` losses and the Hungarian fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ape_tpu_torch.modeling.ape_deta.matchers import stage1_assign, stage2_assign
from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy, elementwise_generalized_box_iou
from ape_tpu_torch.ops.misc import sigmoid_focal_loss

LOSSES = ("class", "boxes")


def _gather_gt(arr: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """arr (B, G, ...) gathered by assign (B, K) -> (B, K, ...); assign < 0 -> slot 0."""
    idx = assign.clamp(0, arr.shape[1] - 1)
    idx = idx.reshape(*assign.shape, *([1] * (arr.dim() - 2))).expand(*assign.shape, *arr.shape[2:])
    return torch.gather(arr, 1, idx)


_HEADS = ("pred_logits", "pred_boxes")


def _to_f32(outputs: Dict) -> Dict:
    """The outputs the losses read, in f32; the rest (memory, text features)
    is left out rather than cast."""
    out = {k: outputs[k].float() for k in _HEADS + ("init_reference",)}
    if "aux_outputs" in outputs:
        out["aux_outputs"] = [{k: aux[k].float() for k in _HEADS} for aux in outputs["aux_outputs"]]
    if "enc_outputs" in outputs:
        enc = outputs["enc_outputs"]
        out["enc_outputs"] = {**{k: enc[k].float() for k in _HEADS + ("anchors",)},
                              "valid": enc["valid"]}
    return out


def default_weight_dict(class_weight=1.0, bbox_weight=5.0, giou_weight=2.0, mask_weight=5.0,
                        dice_weight=5.0):
    """Criterion weights as configured in ape_deta_r50.py:139-147."""
    return {
        "loss_class": class_weight,
        "loss_bbox": bbox_weight,
        "loss_giou": giou_weight,
        "loss_mask": mask_weight,
        "loss_dice": dice_weight,
    }


@dataclasses.dataclass
class DeformableCriterion:
    num_classes: int
    weight_dict: Dict[str, float]
    losses: Sequence[str] = LOSSES
    alpha: float = 0.25
    gamma: float = 2.0
    num_queries: int = 900
    stage2_iou_thresh: float = 0.6
    stage2_max_k: int = 4
    stage1_t_low: float = 0.3
    stage1_t_high: float = 0.7
    stage1_max_k: int = 4

    def __post_init__(self):
        unknown = set(self.losses) - set(LOSSES)
        if unknown:
            raise NotImplementedError(f"the port's criterion has no {sorted(unknown)} losses yet")

    def loss_labels(self, outputs, targets, assign, num_boxes, class_valid):
        logits = outputs["pred_logits"]  # (B, K, C)
        c = logits.shape[-1]
        cls = torch.where(assign >= 0, _gather_gt(targets["labels"], assign),
                          torch.full_like(assign, c))  # background = c
        onehot = F.one_hot(cls, c + 1)[..., :c].to(logits.dtype)  # background row -> zeros
        loss = sigmoid_focal_loss(logits, onehot, self.alpha, self.gamma)
        loss = torch.where(class_valid[:, None, :], loss, torch.zeros_like(loss))
        return {"loss_class": loss.sum() / num_boxes}

    def loss_boxes(self, outputs, targets, assign, num_boxes):
        pred = outputs["pred_boxes"]  # (B, K, 4)
        gt = _gather_gt(targets["boxes"], assign)
        l1 = (pred - gt).abs().sum(-1)
        giou = 1.0 - elementwise_generalized_box_iou(box_cxcywh_to_xyxy(pred), box_cxcywh_to_xyxy(gt))
        m = (assign >= 0).to(pred.dtype)
        return {"loss_bbox": (l1 * m).sum() / num_boxes, "loss_giou": (giou * m).sum() / num_boxes}

    def match(self, outputs, targets, generator=None) -> torch.Tensor:
        """Final-layer (and shared auxiliary) assignment (B, K)."""
        return stage2_assign(targets["boxes"], targets["valid"], outputs["init_reference"],
                             self.num_queries, iou_thresh=self.stage2_iou_thresh,
                             max_k=self.stage2_max_k, generator=generator)

    def match_encoder(self, enc, targets, generator=None) -> torch.Tensor:
        """First-stage assignment of the encoder proposals (B, S)."""
        return stage1_assign(targets["boxes"], targets["valid"], enc["anchors"], enc["valid"],
                             t_low=self.stage1_t_low, t_high=self.stage1_t_high,
                             max_k=self.stage1_max_k, generator=generator)

    def __call__(
        self,
        outputs: Dict,
        targets: Dict,
        num_boxes: torch.Tensor,  # scalar, clamped >= 1
        class_valid: Optional[torch.Tensor] = None,  # (B, C)
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        outputs = _to_f32(outputs)
        if class_valid is None:
            lo = outputs["pred_logits"]
            class_valid = torch.ones(lo.shape[0], lo.shape[2], dtype=torch.bool, device=lo.device)
        with torch.no_grad():
            assign = self.match(outputs, targets, generator)
        losses = {}
        heads = [(outputs, "")] + [(aux, f"_{i}") for i, aux in enumerate(outputs.get("aux_outputs", []))]
        for out, suffix in heads:
            if "class" in self.losses:
                l = self.loss_labels(out, targets, assign, num_boxes, class_valid)
                losses[f"loss_class{suffix}"] = l["loss_class"]
            if "boxes" in self.losses:
                for k, v in self.loss_boxes(out, targets, assign, num_boxes).items():
                    losses[f"{k}{suffix}"] = v

        if "enc_outputs" in outputs:
            enc = outputs["enc_outputs"]
            bin_targets = dict(targets, labels=torch.zeros_like(targets["labels"]))
            with torch.no_grad():
                enc_assign = self.match_encoder(enc, targets, generator)
            enc_valid = torch.ones(enc["pred_logits"].shape[0], 1, dtype=torch.bool,
                                   device=enc["pred_logits"].device)
            losses["loss_class_enc"] = self.loss_labels(
                enc, bin_targets, enc_assign, num_boxes, enc_valid)["loss_class"]
            l = self.loss_boxes(enc, bin_targets, enc_assign, num_boxes)
            losses["loss_bbox_enc"] = l["loss_bbox"]
            losses["loss_giou_enc"] = l["loss_giou"]
        return losses

    def total(self, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Weighted sum using weight_dict with _{i} / _enc fan-out."""
        total = 0.0
        for k, v in losses.items():
            base = k
            for suffix in ("_enc",) + tuple(f"_{i}" for i in range(20)):
                if k.endswith(suffix):
                    base = k[: -len(suffix)]
                    break
            total = total + self.weight_dict.get(base, self.weight_dict.get(k, 1.0)) * v
        return total
