"""DETA-style two-stage deformable transformer (counterpart of
``ape_tpu/modeling/ape_deta/transformer.py``):

  * encoder: num_layers x [window MSDA self-attention -> norm -> FFN -> norm];
  * two-stage proposals (``gen_output_proposals``) and the DETA first-stage
    select (per-level top-k -> per-level NMS -> level-balanced top-k), with the
    scores and boxes of the select in f32;
  * decoder: num_layers x [self-attention -> exact MSDA cross-attention ->
    FFN], iterative box refinement.

Gradients stop (``.detach()``) where JAX's ``jax.lax.stop_gradient`` stops
them: at the selected proposal boxes and features, and at the references
between decoder layers (``with_box_refine``). ``use_act_checkpoint`` recomputes every
encoder and decoder layer in the backward (JAX's ``nn.remat``, policy
``full``).

Parameter names are the reference's detrex names (``encoder.layers.{i}.
attentions.0``, ``ffns.0``, ``norms.{j}``, ``decoder.bbox_embed.{i}``, ...).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ape_tpu_torch.layers.common import FFN, MLP, LayerNorm, Linear, MultiheadAttention
from ape_tpu_torch.layers.msda_module import MultiScaleDeformableAttention
from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy
from ape_tpu_torch.ops.misc import inverse_sigmoid
from ape_tpu_torch.ops.msda import level_start_index
from ape_tpu_torch.ops.nms import NEG_INF, nms_mask, sort_desc, topk


def _run_layer(layer: nn.Module, use_act_checkpoint: bool, *args):
    if use_act_checkpoint and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
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


def encoder_reference_points(spatial_shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """ref[b, q(of level lq), lv] = grid_center(q) / valid[lq] * valid[lv]: (B, S, L, 2)."""
    base = torch.as_tensor(_grid_base(spatial_shapes), dtype=torch.float32,
                           device=valid_ratios.device)
    lq_valid = _per_query_valid(spatial_shapes, valid_ratios)
    return base[None, :, None, :] / lq_valid[:, :, None, :] * valid_ratios[:, None, :, :]


def encoder_grid_corrections(spatial_shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """Pixel shift of the true sampling center against the static grid map of the
    window MSDA: (B, S, L, 2). Zero when there is no padding."""
    base = torch.as_tensor(_grid_base(spatial_shapes), dtype=torch.float32,
                           device=valid_ratios.device)
    lq_valid = _per_query_valid(spatial_shapes, valid_ratios)
    sizes = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                         device=valid_ratios.device)
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


def gen_output_proposals(memory, valid_mask, spatial_shapes, valid_ratios):
    """Per-cell anchor proposals in logit space; invalid cells -> +inf.

    Returns (masked_memory (B,S,C), proposals_unact (B,S,4) f32, proposal_valid (B,S)).
    """
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=memory.device),
            torch.arange(w, dtype=torch.float32, device=memory.device),
            indexing="ij",
        )
        grid = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
        scale = valid_ratios[:, lvl, :] * torch.tensor([w, h], dtype=torch.float32, device=memory.device)
        center = (grid[None] + 0.5) / scale[:, None, :]
        props.append(torch.cat([center, torch.full_like(center, 0.05 * (2.0**lvl))], -1))
    proposals = torch.cat(props, 1)
    ok = ((proposals > 0.01) & (proposals < 0.99)).all(-1) & valid_mask
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
    def __init__(self, embed_dim=256, num_heads=8, feedforward_dim=2048, num_layers=6,
                 num_feature_levels=5, num_points=4, window_radius=4,
                 use_act_checkpoint=False):
        super().__init__()
        self.use_act_checkpoint = use_act_checkpoint
        self.layers = nn.ModuleList(
            EncoderLayer(embed_dim, num_heads, feedforward_dim, num_feature_levels,
                         num_points, window_radius)
            for _ in range(num_layers)
        )

    def forward(self, x, pos, valid_mask, spatial_shapes, reference_points, grid_corrections):
        for layer in self.layers:
            x = _run_layer(layer, self.use_act_checkpoint, x, pos, valid_mask, spatial_shapes,
                           reference_points, grid_corrections)
        return x


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
    """Decoder with iterative box refinement; owns the num_layers + 1 bbox MLPs
    (the extra one scores the encoder proposals)."""

    def __init__(self, embed_dim=256, num_heads=8, feedforward_dim=2048, num_layers=6,
                 num_feature_levels=5, num_points=4, use_act_checkpoint=False):
        super().__init__()
        self.num_layers = num_layers
        self.use_act_checkpoint = use_act_checkpoint
        self.layers = nn.ModuleList(
            DecoderLayer(embed_dim, num_heads, feedforward_dim, num_feature_levels, num_points)
            for _ in range(num_layers)
        )
        self.bbox_embed = nn.ModuleList(MLP(embed_dim, embed_dim, 4, 3) for _ in range(num_layers + 1))

    def enc_bbox_head(self, x):
        return self.bbox_embed[self.num_layers](x)

    def forward(self, query, query_pos, memory, valid_mask, spatial_shapes,
                reference_points, valid_ratios):
        """reference_points (B, K, 4) in sigmoid space. Returns the stacked
        per-layer states (layers, B, K, C) and boxes (layers, B, K, 4). Each
        layer's box refines the previous one's, with the gradient stopped at
        the previous box (``look_forward_twice=False``, as ``ape_tpu``'s
        builds)."""
        x = query
        refs = reference_points
        states, coords = [], []
        vr4 = torch.cat([valid_ratios, valid_ratios], -1)[:, None, :, :]
        for layer, head in zip(self.layers, self.bbox_embed):
            x = _run_layer(layer, self.use_act_checkpoint, x, query_pos, memory, valid_mask,
                           spatial_shapes, refs[:, :, None, :] * vr4)
            new_refs = torch.sigmoid(head(x) + inverse_sigmoid(refs))
            states.append(x)
            coords.append(new_refs)
            refs = new_refs.detach()
        return torch.stack(states), torch.stack(coords)


class DeformableDetrTransformer(nn.Module):
    """Two-stage transformer: flattening, level embeds, proposals, select, decoder."""

    def __init__(self, encoder: DeformableTransformerEncoder, decoder: DeformableTransformerDecoder,
                 embed_dim: int = 256, num_feature_levels: int = 5,
                 two_stage_num_proposals: int = 900):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.two_stage_num_proposals = two_stage_num_proposals
        c = embed_dim
        self.level_embeds = nn.Parameter(torch.randn(num_feature_levels, c))
        self.enc_output = Linear(c, c)
        self.enc_output_norm = LayerNorm(c, eps=1e-5)
        self.pos_trans = Linear(2 * c, 2 * c)
        self.pos_trans_norm = LayerNorm(2 * c, eps=1e-5)
        self.pix_trans = Linear(c, c)
        self.pix_trans_norm = LayerNorm(c, eps=1e-5)

    def forward(self, multi_level_feats, multi_level_masks, multi_level_pos,
                enc_class_head) -> Dict[str, torch.Tensor]:
        """multi_level_feats/pos: per level (B, H, W, C); masks (B, H, W) True = valid.
        enc_class_head: (B, S, C) -> (B, S, 1) binary objectness."""
        b, _, _, c = multi_level_feats[0].shape
        spatial_shapes = tuple((int(f.shape[1]), int(f.shape[2])) for f in multi_level_feats)
        feat = torch.cat([f.reshape(b, -1, c) for f in multi_level_feats], 1)
        valid = torch.cat([m.reshape(b, -1) for m in multi_level_masks], 1)
        pos = torch.cat([p.reshape(b, -1, c) + self.level_embeds[i].to(p.dtype)
                         for i, p in enumerate(multi_level_pos)], 1)
        valid_ratios = valid_ratios_from_masks(multi_level_masks)
        enc_refs = encoder_reference_points(spatial_shapes, valid_ratios)
        grid_corr = encoder_grid_corrections(spatial_shapes, valid_ratios)

        memory = self.encoder(feat, pos, valid, spatial_shapes, enc_refs, grid_corr)

        out_memory, proposals_unact, proposal_valid = gen_output_proposals(
            memory, valid, spatial_shapes, valid_ratios)
        out_memory = self.enc_output_norm(self.enc_output(out_memory))
        # unmasked, as the reference: invalid proposals score the head on zeroed
        # memory and take part in the select
        enc_logits = enc_class_head(out_memory)[..., 0]
        masked_props = torch.where(proposal_valid[..., None], proposals_unact,
                                   torch.zeros_like(proposals_unact))
        enc_coords_unact = self.decoder.enc_bbox_head(out_memory) + masked_props
        # invalid proposals: 30 saturates the sigmoid to 1.0 like the reference's +inf
        enc_coords_unact = torch.where(proposal_valid[..., None], enc_coords_unact,
                                       torch.full_like(enc_coords_unact, 30.0))

        with torch.no_grad():
            sel = deta_first_stage_select(enc_logits, enc_coords_unact, spatial_shapes,
                                          self.two_stage_num_proposals)
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
        }
        if self.training:  # the first stage's outputs, for the losses
            out.update({
                "init_reference": init_reference,  # (B, K, 4)
                "enc_logits": enc_logits,  # (B, S)
                "enc_coords": torch.sigmoid(enc_coords_unact),  # (B, S, 4)
                "proposals": torch.sigmoid(proposals_unact),  # (B, S, 4) anchors
                "proposal_valid": proposal_valid,  # (B, S)
            })
        return out
