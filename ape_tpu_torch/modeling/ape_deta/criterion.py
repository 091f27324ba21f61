"""DETA criterion (counterpart of ``ape_tpu/modeling/ape_deta/criterion.py``),
losses ``("class", "boxes", "masks")``:

  * focal class loss over the text columns, L1 + GIoU box losses;
  * dense mask losses at the mask-feature resolution: focal loss averaged
    over pixels and dice, against GT masks resized by nearest neighbour with
    half-pixel centres (``jax.image.resize(..., "nearest")``); the auxiliary
    layers take them only when the model emits their masks (``aux_mask``);
  * stage2 assignment against the detached initial references, shared by the
    final and the auxiliary decoder layers;
  * stage1 assignment on the binary encoder proposals against their anchors;
  * ``total`` weighs every term by ``weight_dict`` with the ``_{i}`` and
    ``_enc`` suffixes fanned out to their base name.

The outputs the losses read are cast to f32 first (the model may compute in
bf16).
Targets are fixed-shape padded tensors: labels (B, G) int, boxes (B, G, 4)
cxcywh in [0, 1], valid (B, G) bool, and for the mask losses masks
(B, G, Hg, Wg) bool or float in [0, 1].

Not ported yet: the federated class subset, the point-sampled
``masks_maskdino`` loss (``mask_point_sample=True``; without it
``masks_maskdino`` is the dense loss, as in JAX), the ``pred_iou`` /
``anchor_iou`` losses and the Hungarian fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ape_tpu_torch.modeling.ape_deta.matchers import stage1_assign, stage2_assign
from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy, elementwise_generalized_box_iou
from ape_tpu_torch.ops.misc import sigmoid_focal_loss

LOSSES = ("class", "boxes", "masks")  # JAX's default
PORTED = LOSSES + ("masks_maskdino",)  # the dense loss unless mask_point_sample


def _gather_gt(arr: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """arr (B, G, ...) gathered by assign (B, K) -> (B, K, ...); assign < 0 -> slot 0."""
    idx = assign.clamp(0, arr.shape[1] - 1)
    return arr[torch.arange(arr.shape[0], device=arr.device)[:, None], idx]


def resize_nearest(masks: torch.Tensor, size) -> torch.Tensor:
    """(..., H, W) float maps resized to ``size`` by nearest neighbour with
    half-pixel centres, as ``jax.image.resize(..., "nearest")`` picks them
    (torch's "nearest-exact"; its "nearest" takes floor(i * scale))."""
    lead = masks.shape[:-2]
    x = masks.reshape(-1, 1, *masks.shape[-2:])
    x = torch.nn.functional.interpolate(x, size=tuple(size), mode="nearest-exact")
    return x.reshape(*lead, *size)


_HEADS = ("pred_logits", "pred_boxes")


def _heads_f32(out: Dict) -> Dict:
    return {k: out[k].float() for k in _HEADS + ("pred_masks",) if k in out}


def _to_f32(outputs: Dict) -> Dict:
    """The outputs the losses read, in f32; the rest (memory, mask features,
    text features) is left out rather than cast."""
    out = {**_heads_f32(outputs), "init_reference": outputs["init_reference"].float()}
    if "aux_outputs" in outputs:
        out["aux_outputs"] = [_heads_f32(aux) for aux in outputs["aux_outputs"]]
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
    mask_point_sample: bool = False

    def __post_init__(self):
        unknown = set(self.losses) - set(PORTED)
        if unknown:
            raise NotImplementedError(f"the port's criterion has no {sorted(unknown)} losses yet")
        if "masks_maskdino" in self.losses and self.mask_point_sample:
            raise NotImplementedError("the port's criterion has no point-sampled masks_maskdino "
                                      "loss yet (mask_point_sample=True)")

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

    def loss_masks(self, outputs, targets, assign, num_boxes):
        """Dense focal (mean over pixels) and dice losses of the matched
        queries' mask logits; {} when the outputs or targets carry no masks."""
        if "pred_masks" not in outputs or "masks" not in targets:
            return {}
        pred = outputs["pred_masks"]  # (B, K, Hm, Wm) logits
        b, k, hm, wm = pred.shape
        gt = targets["masks"].to(pred.dtype)
        if tuple(gt.shape[-2:]) != (hm, wm):
            gt = resize_nearest(gt, (hm, wm))
        gf = _gather_gt(gt, assign).reshape(b, k, -1)
        pf = pred.reshape(b, k, -1)
        matched = (assign >= 0).to(pred.dtype)
        focal = sigmoid_focal_loss(pf, gf, self.alpha, self.gamma).mean(-1)  # (B, K)
        prob = torch.sigmoid(pf)
        dice = 1.0 - (2 * (prob * gf).sum(-1) + 1.0) / (prob.sum(-1) + gf.sum(-1) + 1.0)
        return {"loss_mask": (focal * matched).sum() / num_boxes,
                "loss_dice": (dice * matched).sum() / num_boxes}

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
            if "masks" in self.losses or "masks_maskdino" in self.losses:
                for k, v in self.loss_masks(out, targets, assign, num_boxes).items():
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
