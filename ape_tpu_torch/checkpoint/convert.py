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
  encoder vl_layers_{i}                 -> vl_layers.{i}.b_attn (the reference's
                                           fusion wrapper, which JAX's converter strips)
  EVA-01 mlp/fc{1,2}, attn/rel_pos_{h,w} -> mlp.fc{1,2}, attn.rel_pos_{h,w} (the
                                           post-norm tree keeps norm1 and norm2)
  ResNet stem_conv / stem_norm          -> stem.conv1 / stem.conv1.norm
  res{s}_block{i}/conv{j}, norm{j}      -> res{s}.{i}.conv{j}, conv{j}.norm
  res{s}_block{i}/shortcut{,_norm}      -> res{s}.{i}.shortcut{,.norm}
  FrozenBN scale / bias / mean / var    -> weight / bias / running_mean /
                                           running_var (buffers)
  decoder {bbox,class}_embed_ambiguous_{i} -> {bbox,class}_embed_ambiguous.{i}
                                           (``proposal_ambiguous``'s head copies)

JAX's converter has no rule for three leaves of the closed-vocabulary and
single-stage trees, which keep JAX's names here: ``class_embedding``,
``transformer.query_embed`` and ``transformer.reference_points``.

``language_state_dict_from_jax`` is likewise the inverse of
``convert_language_state_dict`` for the EVA-CLIP text tower, and
``language_state_dict_from_torch`` reads a torch CLIP checkpoint's text
tower (OpenAI's layout is EVA-CLIP's) as JAX's ``build_clip_text_encoder``
reads it.

``load_checkpoint_tolerant`` loads a checkpoint of reference names (the
released ``.pth`` files, or the port's own) into a port model, as JAX's
``load_params_tolerant`` loads one into its param tree.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Mapping

import numpy as np
import torch

logger = logging.getLogger("ape_tpu_torch")


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


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _convert_resnet(key: str, v):
    """(torch name, numpy value) of a ResNet key (the inverse of JAX's
    ``_convert_resnet``: stem_{conv,norm}, res{s}_block{i}/{conv,norm}{j},
    shortcut{,_norm}), or None."""
    m = re.fullmatch(r"backbone/stem_(conv|norm)/(kernel|scale|bias|mean|var)", key)
    if m:
        return ("backbone.stem.conv1.weight", _conv(v)) if m[1] == "conv" else (
            f"backbone.stem.conv1.norm.{_BN[m[2]]}", np.asarray(v))
    m = re.fullmatch(r"backbone/(res\d)_block(\d+)/(conv\d|norm\d|shortcut|shortcut_norm)/"
                     r"(kernel|scale|bias|mean|var)", key)
    if not m:
        return None
    stage, block, part, kind = m.groups()
    base = f"backbone.{stage}.{block}."
    if part.startswith("conv") or part == "shortcut":
        return f"{base}{part}.weight", _conv(v)
    conv = "shortcut" if part == "shortcut_norm" else f"conv{part[-1]}"
    return f"{base}{conv}.norm.{_BN[kind]}", np.asarray(v)


def _convert_one(key: str, v, neck_levels, num_layers: int):
    """(torch name, numpy value) for one flat flax key, or None."""
    if key.startswith(("backbone/res", "backbone/stem_")):
        return _convert_resnet(key, v)
    m = re.fullmatch(r"backbone/net/patch_embed/(kernel|bias)", key)
    if m:
        return f"backbone.net.patch_embed.proj.{_leaf(m[1])}", _tf(m[1], _conv)(v)
    if key == "backbone/net/pos_embed":
        return "backbone.net.pos_embed", np.asarray(v)
    m = re.fullmatch(r"backbone/net/blocks_(\d+)/(.+)/(kernel|scale|bias)", key)
    if m:
        return f"backbone.net.blocks.{m[1]}.{m[2].replace('/', '.')}.{_leaf(m[3])}", _tf(m[3])(v)
    m = re.fullmatch(r"backbone/net/blocks_(\d+)/attn/([qv]_bias|rel_pos_[hw])", key)
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
    if key in ("transformer/level_embeds", "transformer/query_embed", "class_embedding"):
        return key.replace("/", "."), np.asarray(v)
    m = re.fullmatch(r"transformer/reference_points/(kernel|bias)", key)
    if m:
        return f"transformer.reference_points.{_leaf(m[1])}", _tf(m[1])(v)
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
    m = re.fullmatch(r"transformer/encoder/vl_layers_(\d+)/(?:attn/(\w+)|(layer_norm_[vl]))/"
                     r"(kernel|scale|bias)", key)
    if m:
        i, proj, norm, kind = m.groups()
        part = f"attn.{proj}" if proj else norm
        return f"transformer.encoder.vl_layers.{i}.b_attn.{part}.{_leaf(kind)}", _tf(kind)(v)
    m = re.fullmatch(r"transformer/encoder/vl_layers_(\d+)/(gamma_[vl])", key)
    if m:
        return f"transformer.encoder.vl_layers.{m[1]}.b_attn.{m[2]}", np.asarray(v)
    if key == "name_prompt_fusion_feature":
        return key, np.asarray(v)
    m = re.fullmatch(r"transformer/decoder/bbox_embed(_ambiguous)?_(\d+)/layer(\d+)/(kernel|bias)",
                     key)
    if m:
        amb, i, j, kind = m.groups()
        return (f"transformer.decoder.bbox_embed{amb or ''}.{i}.layers.{j}.{_leaf(kind)}",
                _tf(kind)(v))
    m = re.fullmatch(r"transformer/decoder/class_embed_ambiguous_(\d+)/(kernel|bias)", key)
    if m:
        return f"transformer.decoder.class_embed_ambiguous.{m[1]}.{_leaf(m[2])}", _tf(m[2])(v)
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
    """Flat flax params ("a/b/kernel" -> numpy) of an APE-Ti, APE-L_D, APE-L or
    R50 tree (the protocol's or the masked model's, with or without
    ambiguous head copies; Deformable-DETR's) to the
    port's state_dict. Raises on a key it cannot place."""
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


_TEXT_BLOCK = {"in_proj/kernel": "attn.in_proj_weight", "in_proj/bias": "attn.in_proj_bias",
               "out_proj/kernel": "attn.out_proj.weight", "out_proj/bias": "attn.out_proj.bias",
               "ln_1/scale": "ln_1.weight", "ln_1/bias": "ln_1.bias",
               "ln_2/scale": "ln_2.weight", "ln_2/bias": "ln_2.bias",
               "mlp_fc/kernel": "mlp.c_fc.weight", "mlp_fc/bias": "mlp.c_fc.bias",
               "mlp_proj/kernel": "mlp.c_proj.weight", "mlp_proj/bias": "mlp.c_proj.bias"}
_TEXT_TOP = {"token_embedding/embedding": "token_embedding.weight",
             "positional_embedding": "positional_embedding",
             "text_projection": "text_projection",
             "ln_final/scale": "ln_final.weight", "ln_final/bias": "ln_final.bias"}


def language_state_dict_from_jax(flat_params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax params of ``CLIPTextTransformer`` to the port tower's
    state_dict (the reference's EVA-CLIP names). ``text_projection`` keeps
    its layout: both use it as x @ P. Raises on a key it cannot place."""
    out: Dict[str, np.ndarray] = {}
    unplaced = []
    for key, v in flat_params.items():
        m = re.fullmatch(r"resblocks_(\d+)/(.+)", key)
        if key in _TEXT_TOP:
            out[_TEXT_TOP[key]] = np.asarray(v)
        elif m and m[2] in _TEXT_BLOCK:
            out[f"transformer.resblocks.{m[1]}.{_TEXT_BLOCK[m[2]]}"] = _tf(m[2].split("/")[1])(v)
        else:
            unplaced.append(key)
    if unplaced:
        raise KeyError(f"language_state_dict_from_jax: no rule for {len(unplaced)} keys: "
                       f"{unplaced[:10]}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in out.items()}


_TEXT_SCALARS = ("logit_scale", "input_resolution", "context_length", "vocab_size")


def language_state_dict_from_torch(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CLIP text tower's torch state dict (OpenAI's or EVA-CLIP's layout,
    the keys JAX's ``convert_language_state_dict`` reads) to the port
    tower's, f32: the prefixes ``model_language.``, ``net.`` and ``text.``
    stripped, the image tower (``visual.*``), the four scalars of a whole
    CLIP checkpoint and any ``attn_mask`` dropped, as JAX drops them; a key
    of no other rule is logged and skipped, as JAX's converter does."""
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    blocks = set(_TEXT_BLOCK.values())
    for name, v in state_dict.items():
        if name.startswith("visual.") or name in _TEXT_SCALARS or "attn_mask" in name:
            continue
        for pref in ("model_language.", "net.", "text."):
            name = name.removeprefix(pref)
        m = re.fullmatch(r"transformer\.resblocks\.\d+\.(.+)", name)
        if name in _TEXT_TOP.values() or (m and m[1] in blocks):
            out[name] = v.detach().float().cpu().contiguous()
        elif "logit_scale" not in name:
            unmatched.append(name)
    if unmatched:
        logger.warning(f"language_state_dict_from_torch: unmatched keys: {unmatched[:10]}")
    return out


# ---------------------------------------------------------------------------
# Loading a reference-named checkpoint into the port (counterpart of JAX's
# load_params_tolerant, checkpoint/convert.py:513-562)
# ---------------------------------------------------------------------------

def interpolate_patch_embed(kernel_hwio: np.ndarray, new_hw) -> np.ndarray:
    """Bicubic-resize a (kh, kw, in, out) patch kernel (JAX's
    ``interpolate_patch_embed``, the same f64 products)."""
    from ape_tpu_torch.modeling.backbone.vit_utils import bicubic_resize_matrix

    mh = bicubic_resize_matrix(kernel_hwio.shape[0], new_hw[0]).astype(np.float64)
    mw = bicubic_resize_matrix(kernel_hwio.shape[1], new_hw[1]).astype(np.float64)
    out = np.einsum("Hh,hwio->Hwio", mh, kernel_hwio.astype(np.float64))
    out = np.einsum("Ww,Hwio->HWio", mw, out)
    return out.astype(kernel_hwio.dtype)


def interpolate_pos_embed_np(pos: np.ndarray, new_len: int, num_extra: int = 1) -> np.ndarray:
    """Bicubic-resize a (1, N + extra, C) absolute position table to (1,
    new_len, C) (JAX's ``interpolate_pos_embed_np``)."""
    from ape_tpu_torch.modeling.backbone.vit_utils import bicubic_resize_matrix

    squeeze = pos.ndim == 2
    if squeeze:
        pos = pos[None]
    extra, grid = pos[:, :num_extra], pos[:, num_extra:]
    size, new_size = int(round(grid.shape[1] ** 0.5)), int(round((new_len - num_extra) ** 0.5))
    if size * size != grid.shape[1] or new_size * new_size != new_len - num_extra:
        raise ValueError(f"position table of {grid.shape[1]} rows to {new_len - num_extra}: "
                         "not square grids")
    g = grid.reshape(size, size, -1).astype(np.float64)
    m = bicubic_resize_matrix(size, new_size).astype(np.float64)
    g = np.einsum("Hh,hwc->Hwc", m, g)
    g = np.einsum("Ww,Hwc->HWc", m, g)
    out = np.concatenate([extra.astype(np.float64), g.reshape(1, new_size * new_size, -1)], 1)
    out = out.astype(pos.dtype)
    return out[0] if squeeze else out


def adapt_shapes(src: Dict[str, np.ndarray], dst_shapes: Mapping[str, tuple]) -> Dict[str, np.ndarray]:
    """JAX's ``adapt_shapes`` on reference names: a patch embedding whose
    kernel size differs is resized bicubically (in JAX's (kh, kw, in, out)
    layout, then back), a position table of another grid likewise."""
    out = dict(src)
    for k, v in src.items():
        if k not in dst_shapes or tuple(v.shape) == tuple(dst_shapes[k]):
            continue
        dst = tuple(dst_shapes[k])
        if k.endswith("patch_embed.proj.weight") and v.ndim == 4 and v.shape[:2] == dst[:2]:
            hwio = np.transpose(v, (2, 3, 1, 0))
            out[k] = np.ascontiguousarray(np.transpose(interpolate_patch_embed(hwio, dst[2:]),
                                                       (3, 2, 0, 1)))
            logger.info(f"adapt: {k} {v.shape} -> {dst} (bicubic patch kernel)")
        elif "pos_embed" in k and v.ndim == len(dst) and v.shape[-1] == dst[-1]:
            out[k] = interpolate_pos_embed_np(v, dst[-2])
            logger.info(f"adapt: {k} {v.shape} -> {dst} (bicubic pos embed)")
    return out


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The reference-named arrays of a torch ``.pth``/``.pt``/``.pkl``
    checkpoint (its ``["model"]`` or the bare dict), as NumPy."""
    if not path.endswith((".pth", ".pt", ".pkl")):
        raise ValueError(f"unsupported checkpoint: {path}")
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in sd:
        sd = sd["model"]
    return {k.removeprefix("model.").removeprefix("model_vision."):
            (v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items() if hasattr(v, "shape")}


def load_checkpoint_tolerant(path: str, model: torch.nn.Module) -> Dict[str, list]:
    """Load a reference-named checkpoint into ``model`` in place, as JAX's
    ``load_params_tolerant`` loads one into a param tree: shapes adapted
    (``adapt_shapes``), a key the file lacks keeps the model's value, a
    shape that still differs is skipped; both are logged. Returns
    {"loaded", "missing", "skipped"}."""
    own = model.state_dict()
    src = adapt_shapes(read_state_dict(path), {k: tuple(v.shape) for k, v in own.items()})
    loaded, skipped, new = [], [], {}
    for k, v in src.items():
        if k not in own:
            continue
        if tuple(own[k].shape) == tuple(v.shape):
            new[k] = torch.from_numpy(np.ascontiguousarray(v)).to(own[k].dtype)
            loaded.append(k)
        else:
            skipped.append((k, tuple(v.shape), tuple(own[k].shape)))
    missing = sorted(set(own) - set(new))
    model.load_state_dict(new, strict=False)
    logger.info(f"loaded {len(loaded)}/{len(own)} tensors from {path}")
    if missing:
        logger.warning(f"kept the model's value for {len(missing)} keys: {missing[:10]}")
    if skipped:
        logger.warning(f"shape-skipped: {skipped[:10]}")
    return {"loaded": loaded, "missing": missing, "skipped": skipped}
