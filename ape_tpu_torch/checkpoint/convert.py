"""JAX params -> port state_dict (the inverse of
``ape_tpu/checkpoint/convert.py::convert_torch_state_dict``).

The port's parameter names are the reference's detectron2/detrex names, so
``convert_torch_state_dict(state_dict_from_jax(flat)) == flat``. Layout rules,
inverted:
  flax Dense kernel (in, out)           -> Linear weight (out, in)
  flax Conv kernel (kh, kw, in, out)    -> Conv2d weight (out, in, kh, kw)
  flax ConvTranspose (kh, kw, in, out)  -> ConvTranspose2d weight (in, out, kh, kw),
                                           spatially flipped (flax correlates the
                                           kernel as is, torch scatters it)
  LayerNorm / GroupNorm scale           -> weight
  decoder self-attention q/k/v_proj     -> packed in_proj_weight / in_proj_bias
  mask head lateral_norm / output_norm  -> the ``norm`` of lateral_conv / output_conv
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _linear(w):
    return np.asarray(w).T


def _conv(w):
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _conv_t(w):
    return np.transpose(np.asarray(w)[::-1, ::-1], (2, 3, 0, 1))


def _leaf(kind: str) -> str:
    return {"kernel": "weight", "scale": "weight", "bias": "bias"}[kind]


def _tf(kind: str, conv=_linear):
    return conv if kind == "kernel" else np.asarray


# SimpleFeaturePyramid Sequential indices per stage: (flax part, torch index)
_SFP = {
    "2": {"deconv1": "0", "ln": "1", "deconv2": "3", "conv1x1": "4", "conv3x3": "5"},
    "3": {"deconv1": "0", "conv1x1": "1", "conv3x3": "2"},
    "4": {"conv1x1": "0", "conv3x3": "1"},
    "5": {"conv1x1": "1", "conv3x3": "2"},
}
_ENC_PARTS = {"attn": "attentions.0", "ffn/fc1": "ffns.0.layers.0.0", "ffn/fc2": "ffns.0.layers.1",
              "norm1": "norms.0", "norm2": "norms.1"}
_DEC_PARTS = {"cross_attn": "attentions.1", "ffn/fc1": "ffns.0.layers.0.0",
              "ffn/fc2": "ffns.0.layers.1", "norm1": "norms.0", "norm2": "norms.1",
              "norm3": "norms.2"}


def _convert_one(key: str, v, neck_levels, num_layers: int):
    """(torch name, numpy value) for one flat flax key, or None."""
    m = re.fullmatch(r"backbone/net/patch_embed/(kernel|bias)", key)
    if m:
        return f"backbone.net.patch_embed.proj.{_leaf(m[1])}", _tf(m[1], _conv)(v)
    if key == "backbone/net/pos_embed":
        return "backbone.net.pos_embed", np.asarray(v)
    m = re.fullmatch(r"backbone/net/blocks_(\d+)/(.+)/(kernel|scale|bias)", key)
    if m:
        return f"backbone.net.blocks.{m[1]}.{m[2].replace('/', '.')}.{_leaf(m[3])}", _tf(m[3])(v)
    m = re.fullmatch(r"backbone/net/blocks_(\d+)/attn/([qv]_bias)", key)
    if m:
        return f"backbone.net.blocks.{m[1]}.attn.{m[2]}", np.asarray(v)
    m = re.fullmatch(r"backbone/simfp_(\d)_(\w+?)(/conv|/norm)?/(kernel|scale|bias)", key)
    if m:
        stage, part, sub, kind = m.groups()
        name = f"backbone.simfp_{stage}.{_SFP[stage][part]}"
        if sub == "/norm":
            name += ".norm"
        conv = _conv_t if part.startswith("deconv") else _conv
        return f"{name}.{_leaf(kind)}", _tf(kind, conv)(v)
    m = re.fullmatch(r"neck/(conv|gn)_(\w+)/(kernel|scale|bias)", key)
    if m:
        i = neck_levels.index(m[2])
        return f"neck.convs.{i}.{m[1]}.{_leaf(m[3])}", _tf(m[3], _conv)(v)
    m = re.fullmatch(r"neck/extra_(conv|gn)_(\d+)/(kernel|scale|bias)", key)
    if m:
        return f"neck.extra_convs.{m[2]}.{m[1]}.{_leaf(m[3])}", _tf(m[3], _conv)(v)
    if key == "transformer/level_embeds":
        return "transformer.level_embeds", np.asarray(v)
    m = re.fullmatch(r"transformer/(enc_output|pos_trans|pix_trans)(_norm)?/(kernel|scale|bias)", key)
    if m:
        return f"transformer.{m[1]}{m[2] or ''}.{_leaf(m[3])}", _tf(m[3])(v)
    m = re.fullmatch(r"transformer/(encoder|decoder)/layers_(\d+)/(.+)/(kernel|scale|bias)", key)
    if m:
        side, i, part, kind = m.groups()
        parts = _ENC_PARTS if side == "encoder" else _DEC_PARTS
        head, _, rest = part.partition("/")
        if part in parts:
            name = parts[part]
        elif head in parts:  # MSDA projections
            name = f"{parts[head]}.{rest}"
        else:
            return None
        return f"transformer.{side}.layers.{i}.{name}.{_leaf(kind)}", _tf(kind)(v)
    m = re.fullmatch(r"transformer/decoder/bbox_embed_(\d+)/layer(\d+)/(kernel|bias)", key)
    if m:
        return f"transformer.decoder.bbox_embed.{m[1]}.layers.{m[2]}.{_leaf(m[3])}", _tf(m[3])(v)
    m = re.fullmatch(r"class_embed_(\d+)/dot_product_projection_text/(kernel|bias)", key)
    if m:
        return f"class_embed.{m[1]}.dot_product_projection_text.{_leaf(m[2])}", _tf(m[2])(v)
    m = re.fullmatch(r"class_embed_(\d+)/(log_scale|bias_lang|bias0)", key)
    if m:
        return f"class_embed.{m[1]}.{m[2]}", np.asarray(v)
    m = re.fullmatch(r"enc_class_head_linear/(kernel|bias)", key)
    if m:
        return f"class_embed.{num_layers}.{_leaf(m[1])}", _tf(m[1])(v)
    m = re.fullmatch(r"(lateral|output|mask)_conv/kernel", key)
    if m:
        return f"{m[1]}_conv.weight", _conv(v)
    m = re.fullmatch(r"(lateral|output)_norm/(scale|bias)", key)
    if m:
        return f"{m[1]}_conv.norm.{_leaf(m[2])}", np.asarray(v)
    m = re.fullmatch(r"mask_embed(?:_(\d+))?/layer(\d+)/(kernel|bias)", key)
    if m:
        head = "mask_embed" if m[1] is None else f"mask_embed.{m[1]}"
        return f"{head}.layers.{m[2]}.{_leaf(m[3])}", _tf(m[3])(v)
    return None


def state_dict_from_jax(flat_params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax params ("a/b/kernel" -> numpy) of an APE-Ti tree (the
    protocol's or the masked model's) to the port's state_dict. Raises on a
    key it cannot place."""
    neck_levels = sorted({m[1] for k in flat_params
                          if (m := re.fullmatch(r"neck/conv_(\w+)/kernel", k))})
    num_layers = len({m[1] for k in flat_params if (m := re.match(r"class_embed_(\d+)/", k))})
    out: Dict[str, np.ndarray] = {}
    packed: Dict[str, Dict[str, np.ndarray]] = {}
    unplaced = []
    for key, v in flat_params.items():
        m = re.fullmatch(r"transformer/decoder/layers_(\d+)/self_attn/(\w+)_proj/(kernel|bias)", key)
        if m:
            i, proj, kind = m.groups()
            base = f"transformer.decoder.layers.{i}.attentions.0.attn"
            if proj == "out":
                out[f"{base}.out_proj.{_leaf(kind)}"] = _tf(kind)(v)
            else:
                name = f"{base}.in_proj_{_leaf(kind)}"
                packed.setdefault(name, {})[proj] = _tf(kind)(v)
            continue
        converted = _convert_one(key, v, neck_levels, num_layers)
        if converted is None:
            unplaced.append(key)
        else:
            out[converted[0]] = converted[1]
    for name, qkv in packed.items():
        out[name] = np.concatenate([qkv["q"], qkv["k"], qkv["v"]], axis=0)
    if unplaced:
        raise KeyError(f"state_dict_from_jax: no rule for {len(unplaced)} keys: {unplaced[:10]}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in out.items()}
