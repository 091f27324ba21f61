"""DETA-style deformable transformer (counterpart of
``ape_tpu/modeling/ape_deta/transformer.py``):

  * encoder: num_layers x [window MSDA self-attention -> norm -> FFN -> norm],
    under ``vl_fusion`` each layer after a bi-directional vision-language
    fusion layer (``layers/fuse.py``) when text is given;
  * two-stage proposals (``gen_output_proposals``) and the DETA first-stage
    select (per-level top-k -> per-level NMS -> level-balanced top-k), with the
    scores and boxes of the select in f32, or a plain top-k of the scores
    (``assign_first_stage=False``); or single-stage learned queries;
  * decoder: num_layers x [self-attention -> exact MSDA cross-attention ->
    FFN], iterative box refinement (``with_box_refine``) from 4-d boxes
    or 2-d points;
  * with ``proposal_ambiguous`` N copies of the first stage's objectness
    head and box MLP: per proposal, the argmax over the 1 + N objectness
    logits picks whose logit and box go on (a gather, so the gradient
    reaches the picked head alone, as JAX's ``take_along_axis``).

A mask prompt (B, S) bool, the image's prompt subsampled to each level,
takes the cells it leaves out of the first stage as padding does.

Gradients stop (``.detach()``) where JAX's ``jax.lax.stop_gradient`` stops
them: at the selected proposal boxes and features, and at the references
between decoder layers (``with_box_refine``). ``use_act_checkpoint`` recomputes every
encoder and decoder layer in the backward (JAX's ``nn.remat``), and every
fusion layer (JAX's ``nn.remat(BiAttentionBlock)``): only one fusion layer's
(S, T) logits and softmaxes are then alive at a time. An encoder layer's
recompute follows ``msda_dispatch.REMAT_POLICY``, JAX's ``_remat_policy``: by
default ("msda") it keeps the layer's window-MSDA output from the forward and
recomputes the rest; under ``APE_REMAT_POLICY=full`` it recomputes all. The
decoder and fusion layers are recomputed whole under either.

Parameter names are the reference's detrex names (``encoder.layers.{i}.
attentions.0``, ``ffns.0``, ``norms.{j}``, ``decoder.bbox_embed.{i}``, ...).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ape_tpu_torch.layers.common import FFN, MLP, LayerNorm, Linear, MultiheadAttention
from ape_tpu_torch.layers.fuse import VisionLanguageFusion
from ape_tpu_torch.layers.msda_module import MultiScaleDeformableAttention
from ape_tpu_torch.ops import msda_dispatch
from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy
from ape_tpu_torch.ops.misc import inverse_sigmoid
from ape_tpu_torch.ops.msda import level_start_index
from ape_tpu_torch.ops.msda_dispatch import level_sizes
from ape_tpu_torch.ops.nms import NEG_INF, nms_mask, sort_desc, topk
from ape_tpu_torch.ops.tables import device_table, shapes_key

# the focal prior of the first stage's objectness heads: sigmoid(bias) = 0.01
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def _run_layer(layer: nn.Module, use_act_checkpoint: bool, *args, context_fn=noop_context_fn):
    if use_act_checkpoint and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False, context_fn=context_fn)
    return layer(*args)


# ---------------------------------------------------------------------------
# grid helpers
# ---------------------------------------------------------------------------


def _grid_base(spatial_shapes) -> np.ndarray:
    """Normalized (x, y) centers of every cell of the pyramid grid: (S, 2)."""
    pieces = []
    for hq, wq in spatial_shapes:
        yy, xx = np.meshgrid(np.arange(hq) + 0.5, np.arange(wq) + 0.5, indexing="ij")
        pieces.append(np.stack([xx.reshape(-1) / wq, yy.reshape(-1) / hq], -1))
    return np.concatenate(pieces, 0)


def _per_query_valid(spatial_shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """valid_ratios (B, L, 2) repeated over each query level's cells: (B, S, 2)."""
    b = valid_ratios.shape[0]
    return torch.cat([valid_ratios[:, lvl : lvl + 1].expand(b, h * w, 2)
                      for lvl, (h, w) in enumerate(spatial_shapes)], 1)


@device_table
def _grid_base_on(spatial_shapes, device) -> torch.Tensor:
    """``_grid_base`` as an f32 table on ``device`` (cached: read-only)."""
    return torch.as_tensor(_grid_base(spatial_shapes), dtype=torch.float32, device=device)


def encoder_reference_points(spatial_shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """ref[b, q(of level lq), lv] = grid_center(q) / valid[lq] * valid[lv]: (B, S, L, 2)."""
    base = _grid_base_on(shapes_key(spatial_shapes), valid_ratios.device)
    lq_valid = _per_query_valid(spatial_shapes, valid_ratios)
    return base[None, :, None, :] / lq_valid[:, :, None, :] * valid_ratios[:, None, :, :]


def encoder_grid_corrections(spatial_shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """Pixel shift of the true sampling center against the static grid map of the
    window MSDA: (B, S, L, 2). Zero when there is no padding."""
    base = _grid_base_on(shapes_key(spatial_shapes), valid_ratios.device)
    lq_valid = _per_query_valid(spatial_shapes, valid_ratios)
    sizes = level_sizes(spatial_shapes, valid_ratios.device)
    ratio = valid_ratios[:, None, :, :] / lq_valid[:, :, None, :]
    return base[None, :, None, :] * sizes[None, None, :, :] * (ratio - 1.0)


def valid_ratios_from_masks(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """masks: per level (B, H, W) True = VALID. Returns (B, L, 2) in (x, y)."""
    ratios = []
    for m in masks:
        vh = m[:, :, 0].float().sum(1) / m.shape[1]
        vw = m[:, 0, :].float().sum(1) / m.shape[2]
        ratios.append(torch.stack([vw, vh], -1))
    return torch.stack(ratios, 1)


def level_ids(spatial_shapes, device) -> torch.Tensor:
    return torch.cat([torch.full((h * w,), lvl, dtype=torch.long, device=device)
                      for lvl, (h, w) in enumerate(spatial_shapes)])


# ---------------------------------------------------------------------------
# proposals + DETA first-stage select
# ---------------------------------------------------------------------------


def gen_output_proposals(memory, valid_mask, spatial_shapes, valid_ratios, mask_prompt=None):
    """Per-cell anchor proposals in logit space; invalid cells -> +inf. A
    cell is valid inside the image, with its anchor inside (0.01, 0.99),
    and where ``mask_prompt`` (B, S) bool, if given, allows it.

    Returns (masked_memory (B,S,C), proposals_unact (B,S,4) f32, proposal_valid (B,S)).
    """
    props = []
    sizes = level_sizes(spatial_shapes, memory.device)
    for lvl, (h, w) in enumerate(spatial_shapes):
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=memory.device),
            torch.arange(w, dtype=torch.float32, device=memory.device),
            indexing="ij",
        )
        grid = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
        scale = valid_ratios[:, lvl, :] * sizes[lvl]
        center = (grid[None] + 0.5) / scale[:, None, :]
        props.append(torch.cat([center, torch.full_like(center, 0.05 * (2.0**lvl))], -1))
    proposals = torch.cat(props, 1)
    ok = ((proposals > 0.01) & (proposals < 0.99)).all(-1) & valid_mask
    if mask_prompt is not None:
        ok = ok & mask_prompt
    unact = torch.log(proposals / (1 - proposals.clamp(max=1 - 1e-7)))
    unact = torch.where(ok[..., None], unact, torch.full_like(unact, math.inf))
    mem = torch.where(ok[..., None], memory, torch.zeros_like(memory))
    return mem, unact, ok


def deta_first_stage_select(
    logits: torch.Tensor,  # (B, S) binary objectness
    boxes_unact: torch.Tensor,  # (B, S, 4) cxcywh logit space
    spatial_shapes: Sequence[Tuple[int, int]],
    topk_: int,
    pre_nms_topk: int = 1000,
    nms_thresh: float = 0.9,
) -> torch.Tensor:
    """DETA first-stage proposal selection in f32. Returns indices (B, topk_).

    Per-level top-k -> per-level NMS -> level-balanced pick of topk/L per level
    -> fill the remaining slots by priority (kept-by-NMS first, then score).
    Pad slots of short levels carry index 0 and score NEG_INF, as in JAX.
    """
    num_levels = len(spatial_shapes)
    device = logits.device
    lvl_of = level_ids(spatial_shapes, device)
    starts, _ = level_start_index(spatial_shapes)
    q_per_l = topk_ // num_levels
    k_pad = min(pre_nms_topk, max(h * w for h, w in spatial_shapes))
    score_all = torch.sigmoid(logits.float())
    boxes_all = box_cxcywh_to_xyxy(torch.sigmoid(boxes_unact.float())).clamp(0.0, 1.0)
    out = []
    for score, boxes in zip(score_all, boxes_all):
        cand_idx, cand_valid = [], []
        for lvl, (h, w) in enumerate(spatial_shapes):
            k = min(pre_nms_topk, h * w)
            _, idx = topk(score[starts[lvl] : starts[lvl] + h * w], k)
            cand_idx.append(nn.functional.pad(idx + starts[lvl], (0, k_pad - k)))
            cand_valid.append(torch.arange(k_pad, device=device) < k)
        cand_idx_l = torch.stack(cand_idx)  # (L, K) global indices
        cand_valid_l = torch.stack(cand_valid)
        c_score_l = torch.where(cand_valid_l, score[cand_idx_l], torch.full_like(score[cand_idx_l], NEG_INF))
        # levels never suppress each other: the L level problems run as one batch
        kept_l = nms_mask(boxes[cand_idx_l], c_score_l, nms_thresh, cand_valid_l)

        cand_idx = cand_idx_l.reshape(-1)
        kept = kept_l.reshape(-1)
        c_score = c_score_l.reshape(-1)
        c_level = lvl_of[cand_idx]

        # level-balanced selection among kept, by score order
        _, order = sort_desc(torch.where(kept, c_score, torch.full_like(c_score, NEG_INF)))
        lvl_sorted = c_level[order]
        kept_sorted = kept[order]
        onehot = nn.functional.one_hot(lvl_sorted, num_levels) * kept_sorted[:, None].long()
        my_rank = torch.cumsum(onehot, 0).gather(1, lvl_sorted[:, None])[:, 0]
        balanced = torch.zeros_like(kept)
        balanced[order] = kept_sorted & (my_rank <= q_per_l)

        prio = balanced.float() * 4.0 + kept.float() * 2.0 + c_score
        _, sel_c = topk(prio, topk_)
        out.append(cand_idx[sel_c])
    return torch.stack(out)


def proposal_pos_embed(proposals_unact, num_pos_feats: int = 128):
    """Sine embedding of sigmoid(proposals): (B, K, 4) -> (B, K, 4*num_pos_feats)."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=proposals_unact.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos = torch.sigmoid(proposals_unact) * (2 * math.pi)
    pos = pos[..., None] / dim_t
    emb = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], -1)
    return emb.reshape(*proposals_unact.shape[:-1], -1)


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


class EncoderLayer(nn.Module):
    def __init__(self, embed_dim, num_heads, feedforward_dim, num_feature_levels,
                 num_points=4, window_radius=4):
        super().__init__()
        self.attentions = nn.ModuleList([MultiScaleDeformableAttention(
            embed_dim, num_heads, num_feature_levels, num_points, window_radius)])
        self.ffns = nn.ModuleList([FFN(embed_dim, feedforward_dim)])
        self.norms = nn.ModuleList([LayerNorm(embed_dim, eps=1e-5) for _ in range(2)])

    def forward(self, x, pos, valid_mask, spatial_shapes, reference_points, grid_corrections):
        x = self.attentions[0](
            query=x, value=x, spatial_shapes=spatial_shapes, reference_points=reference_points,
            query_pos=pos, key_padding_mask=~valid_mask, mode="window",
            grid_corrections=grid_corrections,
        )
        x = self.norms[0](x)
        return self.norms[1](self.ffns[0](x))


class DeformableTransformerEncoder(nn.Module):
    """Encoder layers, each after a fusion layer ``vl_layers.{i}`` under
    ``vl_fusion`` (the reference's defaults: embed 2048, 8 heads, layer
    scale 1e-4; APE-L_D builds it with 1/6)."""

    def __init__(self, embed_dim=256, num_heads=8, feedforward_dim=2048, num_layers=6,
                 num_feature_levels=5, num_points=4, window_radius=4,
                 use_act_checkpoint=False, vl_fusion=False, vl_embed_dim=2048, vl_num_heads=8,
                 vl_init_values=1e-4, embed_dim_language=1024):
        super().__init__()
        self.use_act_checkpoint = use_act_checkpoint
        self.layers = nn.ModuleList(
            EncoderLayer(embed_dim, num_heads, feedforward_dim, num_feature_levels,
                         num_points, window_radius)
            for _ in range(num_layers)
        )
        self.vl_layers = nn.ModuleList(
            VisionLanguageFusion(embed_dim, embed_dim_language, vl_embed_dim, vl_num_heads,
                                 vl_init_values)
            for _ in range(num_layers)) if vl_fusion else None

    def forward(self, x, pos, valid_mask, spatial_shapes, reference_points, grid_corrections,
                text=None, text_valid=None):
        """Returns (memory, text): the text fused by every fusion layer, or
        as given when there is no fusion or no text."""
        for i, layer in enumerate(self.layers):
            if self.vl_layers is not None and text is not None:
                x, text = _run_layer(self.vl_layers[i], self.use_act_checkpoint, x, text,
                                     text_valid)
            x = _run_layer(layer, self.use_act_checkpoint, x, pos, valid_mask, spatial_shapes,
                           reference_points, grid_corrections,
                           context_fn=msda_dispatch.remat_context_fn())
        return x, text


class DecoderLayer(nn.Module):
    def __init__(self, embed_dim, num_heads, feedforward_dim, num_feature_levels, num_points=4):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dim, num_heads),
            MultiScaleDeformableAttention(embed_dim, num_heads, num_feature_levels, num_points),
        ])
        self.ffns = nn.ModuleList([FFN(embed_dim, feedforward_dim)])
        self.norms = nn.ModuleList([LayerNorm(embed_dim, eps=1e-5) for _ in range(3)])

    def forward(self, x, query_pos, memory, valid_mask, spatial_shapes, reference_points):
        x = self.attentions[0](x, query_pos=query_pos, key_pos=query_pos)
        x = self.norms[0](x)
        x = self.attentions[1](
            query=x, value=memory, spatial_shapes=spatial_shapes,
            reference_points=reference_points, query_pos=query_pos,
            key_padding_mask=~valid_mask, mode="exact",
        )
        x = self.norms[1](x)
        return self.norms[2](self.ffns[0](x))


class DeformableTransformerDecoder(nn.Module):
    """Decoder with iterative box refinement (``with_box_refine``; without
    it every layer samples around the initial references); owns a bbox MLP
    a layer and, with ``enc_bbox_head`` (a two-stage transformer's), one
    more that scores the encoder's proposals; with ``proposal_ambiguous``
    N copies of the first stage's heads, ``class_embed_ambiguous.{i}``
    (``Linear(C, 1)`` with the focal prior bias) and
    ``bbox_embed_ambiguous.{i}`` (the 3-layer box MLP)."""

    def __init__(self, embed_dim=256, num_heads=8, feedforward_dim=2048, num_layers=6,
                 num_feature_levels=5, num_points=4, use_act_checkpoint=False,
                 with_box_refine=True, enc_bbox_head=True, proposal_ambiguous=0,
                 look_forward_twice=False):
        super().__init__()
        self.num_layers = num_layers
        self.use_act_checkpoint = use_act_checkpoint
        self.with_box_refine = with_box_refine
        self.look_forward_twice = look_forward_twice
        self.layers = nn.ModuleList(
            DecoderLayer(embed_dim, num_heads, feedforward_dim, num_feature_levels, num_points)
            for _ in range(num_layers)
        )
        self.bbox_embed = nn.ModuleList(MLP(embed_dim, embed_dim, 4, 3)
                                        for _ in range(num_layers + int(enc_bbox_head)))
        self.proposal_ambiguous = proposal_ambiguous
        if proposal_ambiguous:
            self.bbox_embed_ambiguous = nn.ModuleList(
                MLP(embed_dim, embed_dim, 4, 3) for _ in range(proposal_ambiguous))
            self.class_embed_ambiguous = nn.ModuleList(
                Linear(embed_dim, 1) for _ in range(proposal_ambiguous))
            for head in self.class_embed_ambiguous:
                nn.init.constant_(head.bias, PRIOR_BIAS)

    def enc_bbox_head(self, x):
        return self.bbox_embed[self.num_layers](x)

    def enc_ambiguous_heads(self, x):
        """The copies' objectness logits [(B, S)] and box deltas [(B, S, 4)]."""
        return ([h(x)[..., 0] for h in self.class_embed_ambiguous],
                [h(x) for h in self.bbox_embed_ambiguous])

    def forward(self, query, query_pos, memory, valid_mask, spatial_shapes,
                reference_points, valid_ratios):
        """reference_points (B, K, 4) boxes or (B, K, 2) points (the
        single-stage Deformable-DETR's), in sigmoid space. Returns the
        stacked per-layer states (layers, B, K, C) and boxes (layers, B, K,
        4). A layer's box refines its reference: all four coordinates of a
        box; of a point, x and y, with w and h from the head alone. Under
        ``with_box_refine`` the next layer's reference is that box, with the
        gradient stopped there; else every layer keeps the initial one. With
        ``look_forward_twice`` (JAX's default, which the model configs turn
        off) a layer's output box refines the previous layer's box before
        the stop, so its gradient reaches both heads; the values are the
        same."""
        x = query
        refs = prev_live = reference_points
        states, coords = [], []
        for layer, head in zip(self.layers, self.bbox_embed):
            vr = valid_ratios if refs.shape[-1] == 2 else torch.cat([valid_ratios, valid_ratios], -1)
            x = _run_layer(layer, self.use_act_checkpoint, x, query_pos, memory, valid_mask,
                           spatial_shapes, refs[:, :, None, :] * vr[:, None, :, :])
            delta = head(x)
            if refs.shape[-1] == 4:
                new_refs = torch.sigmoid(delta + inverse_sigmoid(refs))
            else:
                new_refs = torch.sigmoid(torch.cat([delta[..., :2] + inverse_sigmoid(refs),
                                                    delta[..., 2:]], -1))
            states.append(x)
            if self.look_forward_twice and prev_live.shape[-1] == 4:
                coords.append(torch.sigmoid(delta + inverse_sigmoid(prev_live)))
            else:
                coords.append(new_refs)
            prev_live = new_refs
            if self.with_box_refine:
                refs = new_refs.detach()
        return torch.stack(states), torch.stack(coords)


class DeformableDetrTransformer(nn.Module):
    """Flattening, level embeds, the encoder, then the decoder's queries:
    two-stage (``as_two_stage``), from the encoder's proposals by DETA's
    select (``assign_first_stage``) or a plain top-k of their scores; or
    single-stage, from learned ``query_embed`` (K, 2C) and 2-d
    ``reference_points`` (the Deformable-DETR R50 recipes). DETA's select
    keeps ``pre_nms_topk`` candidates a level and suppresses them at IoU
    ``nms_thresh_enc``."""

    def __init__(self, encoder: DeformableTransformerEncoder, decoder: DeformableTransformerDecoder,
                 embed_dim: int = 256, num_feature_levels: int = 5,
                 two_stage_num_proposals: int = 900, as_two_stage: bool = True,
                 assign_first_stage: bool = True, pre_nms_topk: int = 1000,
                 nms_thresh_enc: float = 0.9):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.two_stage_num_proposals = two_stage_num_proposals
        self.pre_nms_topk = pre_nms_topk
        self.nms_thresh_enc = nms_thresh_enc
        self.as_two_stage = as_two_stage
        self.assign_first_stage = assign_first_stage
        c = embed_dim
        self.level_embeds = nn.Parameter(torch.randn(num_feature_levels, c))
        if not as_two_stage:
            self.query_embed = nn.Parameter(torch.randn(two_stage_num_proposals, 2 * c))
            self.reference_points = Linear(c, 2)
            return
        self.enc_output = Linear(c, c)
        self.enc_output_norm = LayerNorm(c, eps=1e-5)
        self.pos_trans = Linear(2 * c, 2 * c)
        self.pos_trans_norm = LayerNorm(2 * c, eps=1e-5)
        self.pix_trans = Linear(c, c)
        self.pix_trans_norm = LayerNorm(c, eps=1e-5)

    def _single_stage(self, b, feat, memory, valid, spatial_shapes, valid_ratios, text):
        """The decoder on the learned queries; in training, JAX's placeholder
        first-stage outputs, no proposal valid (their losses take no
        gradient)."""
        c = feat.shape[-1]
        query_pos, query = self.query_embed.to(feat.dtype)[None].expand(b, -1, -1).split(c, -1)
        init_reference = torch.sigmoid(self.reference_points(query_pos))  # (B, K, 2)
        inter_states, output_coords = self.decoder(
            query, query_pos, memory, valid, spatial_shapes, init_reference, valid_ratios)
        out = {"inter_states": inter_states, "output_coords": output_coords, "memory": memory,
               "text": text}
        if self.training:
            s = feat.shape[1]
            out.update({
                "init_reference": init_reference,
                "enc_logits": feat.new_zeros(b, s),
                "enc_coords": feat.new_full((b, s, 4), 0.5),
                "proposals": feat.new_full((b, s, 4), 0.5),
                "proposal_valid": torch.zeros(b, s, dtype=torch.bool, device=feat.device),
            })
        return out

    def forward(self, multi_level_feats, multi_level_masks, multi_level_pos,
                enc_class_head=None, text=None, text_valid=None,
                mask_prompt=None) -> Dict[str, torch.Tensor]:
        """multi_level_feats/pos: per level (B, H, W, C); masks (B, H, W) True = valid.
        enc_class_head: (B, S, C) -> (B, S, 1) binary objectness (two-stage
        only). text (B, T, Cl) and text_valid (B, T), or None: what the
        encoder's fusion layers see; ``"text"`` in the result is the text
        they return. mask_prompt: (B, S) bool over the flattened levels, the
        cells the first stage may propose (two-stage only)."""
        b, _, _, c = multi_level_feats[0].shape
        spatial_shapes = tuple((int(f.shape[1]), int(f.shape[2])) for f in multi_level_feats)
        feat = torch.cat([f.reshape(b, -1, c) for f in multi_level_feats], 1)
        valid = torch.cat([m.reshape(b, -1) for m in multi_level_masks], 1)
        pos = torch.cat([p.reshape(b, -1, c) + self.level_embeds[i].to(p.dtype)
                         for i, p in enumerate(multi_level_pos)], 1)
        valid_ratios = valid_ratios_from_masks(multi_level_masks)
        enc_refs = encoder_reference_points(spatial_shapes, valid_ratios)
        grid_corr = encoder_grid_corrections(spatial_shapes, valid_ratios)

        memory, text = self.encoder(feat, pos, valid, spatial_shapes, enc_refs, grid_corr,
                                    text, text_valid)
        if not self.as_two_stage:
            return self._single_stage(b, feat, memory, valid, spatial_shapes, valid_ratios, text)

        out_memory, proposals_unact, proposal_valid = gen_output_proposals(
            memory, valid, spatial_shapes, valid_ratios, mask_prompt)
        out_memory = self.enc_output_norm(self.enc_output(out_memory))
        # unmasked, as the reference: invalid proposals score the head on zeroed
        # memory and take part in the select
        enc_logits = enc_class_head(out_memory)[..., 0]
        masked_props = torch.where(proposal_valid[..., None], proposals_unact,
                                   torch.zeros_like(proposals_unact))
        enc_coords_unact = self.decoder.enc_bbox_head(out_memory) + masked_props
        heads = None
        if self.decoder.proposal_ambiguous:
            # per proposal, the head with the largest objectness logit gives
            # its logit and its box (jnp.argmax: the first on a tie)
            amb_cls, amb_box = self.decoder.enc_ambiguous_heads(out_memory)
            cls_stack = torch.stack([enc_logits] + amb_cls, 1)  # (B, 1 + N, S)
            box_stack = torch.stack([enc_coords_unact] + [bx + masked_props for bx in amb_box],
                                    1)  # (B, 1 + N, S, 4)
            heads = cls_stack.argmax(1)  # (B, S)
            enc_logits = cls_stack.gather(1, heads[:, None])[:, 0]
            enc_coords_unact = box_stack.gather(
                1, heads[:, None, :, None].expand(-1, 1, -1, 4))[:, 0]
        # invalid proposals: 30 saturates the sigmoid to 1.0 like the reference's +inf
        enc_coords_unact = torch.where(proposal_valid[..., None], enc_coords_unact,
                                       torch.full_like(enc_coords_unact, 30.0))

        with torch.no_grad():
            if self.assign_first_stage:
                sel = deta_first_stage_select(enc_logits, enc_coords_unact, spatial_shapes,
                                              self.two_stage_num_proposals, self.pre_nms_topk,
                                              self.nms_thresh_enc)
            else:  # a plain top-k of the scores: no NMS, no host sync
                sel = topk(enc_logits, self.two_stage_num_proposals)[1]
        topk_coords_unact = enc_coords_unact.gather(1, sel[..., None].expand(-1, -1, 4)).detach()
        init_reference = torch.sigmoid(topk_coords_unact)

        pos_trans = self.pos_trans_norm(self.pos_trans(
            proposal_pos_embed(topk_coords_unact, num_pos_feats=c // 2).to(feat.dtype)))
        query_pos, query = pos_trans.chunk(2, dim=-1)
        topk_feats = out_memory.gather(1, sel[..., None].expand(-1, -1, c)).detach()
        query = query + self.pix_trans_norm(self.pix_trans(topk_feats))

        inter_states, output_coords = self.decoder(
            query, query_pos, memory, valid, spatial_shapes, init_reference, valid_ratios)
        out = {
            "inter_states": inter_states,  # (layers, B, K, C)
            "output_coords": output_coords,  # (layers, B, K, 4) sigmoid space
            "first_stage_indices": sel,  # (B, K)
            "memory": memory,  # (B, S, C)
            "text": text,  # (B, T, Cl) after the fusion layers, or as given, or None
        }
        if heads is not None:
            out["first_stage_heads"] = heads  # (B, S) the head each proposal took
        if self.training:  # the first stage's outputs, for the losses
            out.update({
                "init_reference": init_reference,  # (B, K, 4)
                "enc_logits": enc_logits,  # (B, S)
                "enc_coords": torch.sigmoid(enc_coords_unact),  # (B, S, 4)
                "proposals": torch.sigmoid(proposals_unact),  # (B, S, 4) anchors
                "proposal_valid": proposal_valid,  # (B, S)
            })
        return out
