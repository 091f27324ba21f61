"""DETA criterion (counterpart of ``ape_tpu/modeling/ape_deta/criterion.py``),
losses ``("class", "boxes", "masks")``:

  * focal class loss over the text columns, with ``use_fed_loss`` over the
    federated class subset (every ground-truth class and a weighted draw of
    ``fed_loss_num_classes`` columns by the Gumbel top-k trick); L1 + GIoU
    box losses;
  * dense mask losses at the mask-feature resolution: focal loss averaged
    over pixels and dice, against GT masks resized by nearest neighbour with
    half-pixel centres (``jax.image.resize(..., "nearest")``); the auxiliary
    layers take them only when the model emits their masks (``aux_mask``);
  * stage2 assignment against the detached initial references, shared by the
    final and the auxiliary decoder layers; with ``use_stage2=False`` (the
    Deformable-DETR R50 recipes) each decoder layer matched by the
    Hungarian instead (focal, L1 and GIoU costs, JAX's auction on the host:
    ``matchers.hungarian_match``, one host sync a call);
  * stage1 assignment on the binary encoder proposals against their anchors;
  * ``total`` weighs every term by ``weight_dict`` with the ``_{i}`` and
    ``_enc`` suffixes fanned out to their base name.

The outputs the losses read are cast to f32 first (the model may compute in
bf16).
Targets are fixed-shape padded tensors: labels (B, G) int, boxes (B, G, 4)
cxcywh in [0, 1], valid (B, G) bool, and for the mask losses masks
(B, G, Hg, Wg) bool or float in [0, 1].

The federated subset's uniforms are drawn once a call, for every logits
width at once, on the generator's device and copied in one transfer
(``draw_fed_uniforms``), so a run on the card and one on the CPU given
generators of one seed keep the same columns; the selection itself
(``fed_class_mask``) is deterministic. As in JAX, the binary first-stage
loss takes the subset too: its one column broadcasts against the
vocabulary-wide mask, so with any first-stage match that loss is summed once
per kept column (ROADMAP, Queue 3, trait 10).

Not ported yet: the point-sampled ``masks_maskdino`` loss
(``mask_point_sample=True``; without it ``masks_maskdino`` is the dense loss,
as in JAX) and the ``pred_iou`` / ``anchor_iou`` losses.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F

from ape_tpu_torch.modeling.ape_deta.matchers import (
    hungarian_match,
    stage1_assign,
    stage2_assign,
)
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


def _fed_pad_value(w: torch.Tensor, pad_type: Optional[str], num_classes: int) -> torch.Tensor:
    """The weight of the classes past a weight table shorter than num_classes."""
    n = w.shape[0]
    if pad_type == "max":
        return w.max()
    if pad_type == "max1000":
        return w.max() * 1000.0
    if pad_type == "mean":
        return w.mean()
    if pad_type == "median":  # torch.median's: the lower of the two middle values
        return w.sort().values[(n - 1) // 2]
    if pad_type == "cat":
        return w.new_zeros(())
    k = min(max(int(num_classes * 7.0 / 10), 1), n)  # the k-th smallest, 1-indexed
    return w.sort().values[k - 1]


def fed_class_mask(weights: torch.Tensor, uniforms: torch.Tensor, cls: torch.Tensor,
                   matched: torch.Tensor, c: int, num_sample: int,
                   pad_start: Optional[int] = None) -> torch.Tensor:
    """The federated class subset (JAX's ``_fed_class_mask``): every
    ground-truth class, and the classes whose log weight plus Gumbel noise
    from ``uniforms`` (c,) in (0, 1) reaches the ``num_sample``-th largest
    score; columns past the weights weigh 1e-12; with ``pad_start`` (the
    "cat" pad) every column from it on. cls (B, K) classes of the matched
    queries, matched (B, K). Returns the column mask, (c,) bool, or the
    weights' length where that is longer than c, as JAX broadcasts it."""
    device = weights.device
    gt = torch.where(matched, cls, torch.full_like(cls, c)).reshape(-1)
    is_gt = torch.zeros(c + 1, dtype=torch.bool, device=device).index_fill_(0, gt, True)[:-1]
    w = weights.float().clamp(min=1e-12)
    if w.shape[0] < c:
        w = torch.cat([w, torch.full((c - w.shape[0],), 1e-12, device=device)])
    gumbel = -torch.log(-torch.log(uniforms))
    score = torch.where(is_gt, torch.full((), torch.inf, device=device), torch.log(w) + gumbel)
    kth = torch.topk(score, min(num_sample, c)).values[-1]
    mask = is_gt | (score >= kth)
    if pad_start is not None:
        mask = mask | (torch.arange(c, device=device) >= pad_start)
    return mask


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
    # False: every decoder layer matched by the Hungarian, not stage2
    use_stage2: bool = True
    stage2_iou_thresh: float = 0.6
    stage2_max_k: int = 4
    stage1_t_low: float = 0.3
    stage1_t_high: float = 0.7
    stage1_max_k: int = 4
    mask_point_sample: bool = False
    # the federated class subset (JAX's fields): weights (num_classes,) or
    # shorter, padded by fed_loss_pad_type: "max", "max1000", "mean",
    # "median" (the lower one) or "cat" (weight 0, and the appended range
    # always kept); by default the weights' k-th smallest, k = 7/10 of
    # num_classes
    use_fed_loss: bool = False
    fed_loss_num_classes: int = 50
    fed_loss_cls_weights: Optional[torch.Tensor] = None
    fed_loss_pad_type: Optional[str] = None

    def __post_init__(self):
        unknown = set(self.losses) - set(PORTED)
        if unknown:
            raise NotImplementedError(f"the port's criterion has no {sorted(unknown)} losses yet")
        if "masks_maskdino" in self.losses and self.mask_point_sample:
            raise NotImplementedError("the port's criterion has no point-sampled masks_maskdino "
                                      "loss yet (mask_point_sample=True)")
        self._fed_pad_start = None
        w = self.fed_loss_cls_weights
        if w is None:
            if self.use_fed_loss:
                logging.getLogger(__name__).warning(
                    "use_fed_loss=True but fed_loss_cls_weights is None: the federated class "
                    "subset is off and loss_labels is the plain focal loss")
            return
        w = torch.as_tensor(w, dtype=torch.float32)
        n = w.shape[0]
        if n > self.num_classes:
            raise ValueError(f"fed_loss_cls_weights has {n} entries > num_classes="
                             f"{self.num_classes}")
        if n < self.num_classes:
            if self.fed_loss_pad_type == "cat":
                self._fed_pad_start = n
            pad = _fed_pad_value(w, self.fed_loss_pad_type, self.num_classes)
            w = torch.cat([w, pad.expand(self.num_classes - n)])
        self.fed_loss_cls_weights = w

    def draw_fed_uniforms(self, widths: Iterable[int], generator: Optional[torch.Generator],
                          device) -> Dict[int, torch.Tensor]:
        """{width: uniforms (width,) in [1e-9, 1) on ``device``} for the
        federated subset of logits of each width, drawn at once on the
        generator's device (the CPU's default one without a generator) and
        copied in one transfer. JAX draws them from one key per step, so
        every decoder layer's class loss shares its width's draw."""
        widths = sorted(set(widths))
        gen_device = generator.device if generator is not None else "cpu"
        u = torch.rand(sum(widths), generator=generator, device=gen_device).clamp_(min=1e-9)
        return dict(zip(widths, u.to(device).split(widths)))

    def loss_labels(self, outputs, targets, assign, num_boxes, class_valid, fed_uniforms=None):
        """fed_uniforms: {logits width: uniforms} of the federated subset
        (``draw_fed_uniforms``), or None for the plain focal loss."""
        logits = outputs["pred_logits"]  # (B, K, C)
        c = logits.shape[-1]
        cls = torch.where(assign >= 0, _gather_gt(targets["labels"], assign),
                          torch.full_like(assign, c))  # background = c
        onehot = F.one_hot(cls, c + 1)[..., :c].to(logits.dtype)  # background row -> zeros
        col_mask = class_valid
        if fed_uniforms is not None:
            col_mask = col_mask & fed_class_mask(
                self.fed_loss_cls_weights.to(logits.device), fed_uniforms[c], cls, assign >= 0,
                c, self.fed_loss_num_classes, self._fed_pad_start)[None, :]
        loss = sigmoid_focal_loss(logits, onehot, self.alpha, self.gamma)
        loss = torch.where(col_mask[:, None, :], loss, torch.zeros_like(loss))
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
        heads = [(outputs, "")] + [(aux, f"_{i}") for i, aux in enumerate(outputs.get("aux_outputs", []))]
        if self.use_stage2:
            with torch.no_grad():
                assigns = [self.match(outputs, targets, generator)] * len(heads)
        else:
            assigns = hungarian_match([h for h, _ in heads], targets["labels"], targets["boxes"],
                                      targets["valid"]).unbind(0)
        fed_u = None
        if self.use_fed_loss and self.fed_loss_cls_weights is not None:
            widths = [outputs["pred_logits"].shape[-1]]
            if "enc_outputs" in outputs:
                widths.append(outputs["enc_outputs"]["pred_logits"].shape[-1])
            fed_u = self.draw_fed_uniforms(widths, generator, outputs["pred_logits"].device)
        losses = {}
        for (out, suffix), assign in zip(heads, assigns):
            if "class" in self.losses:
                l = self.loss_labels(out, targets, assign, num_boxes, class_valid, fed_u)
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
                enc, bin_targets, enc_assign, num_boxes, enc_valid, fed_u)["loss_class"]
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
