"""Helpers for the tests that hold ``ape_tpu_torch`` against ``ape_tpu``.

Both sides get the same weights: seeded numpy values in the shapes of the
flax params (no bias stays at zero), carried into the port with
``state_dict_from_jax``. A port module is
loaded under the full-model name of the place it holds in APE, so one
converter serves every module test.
"""

import os
import re

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.parity_harness import DIMS



def cap_torch_threads():
    """Give each pytest-xdist worker its share of the cores for torch's
    intra-op threads, and at least two. Left alone, each of N workers
    starts one thread per core, so the port's tiny models run N-fold
    oversubscribed and their times measure the neighbours. Not one thread:
    the summation order of one thread moves two entries of
    test_torch_masks.py's masked sem_seg (magnitude ~25) 1.2e-4 from JAX's,
    past that test's 1e-4, where two to eight threads stay inside it. One
    process keeps torch's default."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(2, len(os.sched_getaffinity(0)) // workers))


# every worker imports every test module while it collects, so this runs in
# each worker before any of the port's tests
cap_torch_threads()

PROTOCOL_SCALES = (2.0, 1.0, 0.5)
MASKED_SCALES = (4.0, 2.0, 1.0, 0.5)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def _synth(key, shape, rng, heads, points):
    """A seeded value for one flax leaf: fan-in scaled kernels, norm scales
    near 1, the MSDA ring init on offset biases, small noise elsewhere."""
    from ape_tpu.layers.msda_module import _offset_bias_init

    noise = rng.normal(0.0, 0.05, shape)
    if key.endswith("/kernel"):
        return rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
    if key.endswith("/scale"):
        return 1.0 + noise
    if key.endswith("sampling_offsets/bias"):
        levels = shape[0] // (2 * heads * points)
        return _offset_bias_init(heads, levels, points) + noise
    return noise


def init_params(module, *args, seed=0, heads=DIMS["heads"], points=4, **kwargs):
    """Seeded numpy params with the shapes of ``module.init(*args, **kwargs)``
    (traced, not compiled): returns (flat numpy dict, param tree for ``apply``).
    ``heads`` and ``points`` size the MSDA ring init of offset biases."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(key, *args, **kwargs))["params"]
    rng = np.random.RandomState(seed)
    flat = {k: _synth(k, v.shape, rng, heads, points).astype(np.float32)
            for k, v in sorted(flatten(shapes).items())}
    return flat, unflatten(flat)


def load_port(module, flat, jax_prefix, torch_prefix):
    """Load flax params of a module that sits at ``jax_prefix`` in the APE tree
    into the port module that sits at ``torch_prefix`` (strict)."""
    from ape_tpu_torch.checkpoint.convert import state_dict_from_jax

    sd = state_dict_from_jax({jax_prefix + k: v for k, v in flat.items()})
    module.load_state_dict({k[len(torch_prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def model_pair(jax_model, torch_model, zero_encoder_offsets=False):
    """An ape_tpu APEDeta and the port's with the same seeded weights:
    (jax model, param tree, flat params, port model). With
    ``zero_encoder_offsets`` the encoder's sampling_offsets kernels are 0, as
    the reference initialises them."""
    flat, _ = init_params(jax_model, *(jnp.asarray(a) for a in tiny_inputs()))
    if zero_encoder_offsets:
        flat = {k: (np.zeros_like(v) if re.fullmatch(r"transformer/encoder/.*sampling_offsets/kernel", k)
                    else v) for k, v in flat.items()}
    return jax_model, unflatten(flat), flat, load_port(torch_model, flat, "", "")


def jax_tiny(d=DIMS, window_radius=4, scale_factors=PROTOCOL_SCALES, **apedeta_kw):
    """ape_tpu APEDeta at the parity-harness dims on the given pyramid; the
    neck extends it to 5 levels. ``apedeta_kw`` (mask_on, aux_mask, ...) go
    to APEDeta; the mask head reads the finest level."""
    from ape_tpu.modeling.ape_deta.model import APEDeta, ChannelMapper
    from ape_tpu.modeling.ape_deta.transformer import (
        DeformableDetrTransformer,
        DeformableTransformerDecoder,
        DeformableTransformerEncoder,
    )
    from ape_tpu.modeling.backbone.eva_vit import EVAViT, SimpleFeaturePyramid
    from ape_tpu_torch.modeling.build import pyramid_features

    _, levels = pyramid_features(scale_factors)
    backbone = SimpleFeaturePyramid(
        net=EVAViT(img_size=d["img"], patch_size=16, embed_dim=d["vit_embed"],
                   depth=d["vit_depth"], num_heads=d["vit_heads"], mlp_ratio=4 * 2 / 3,
                   window_size=d["win"], window_block_indexes=(0,),
                   pretrain_img_size=224, pt_hw_seq_len=16, packed_swiglu=True),
        out_channels=d["embed"], scale_factors=scale_factors)
    transformer = DeformableDetrTransformer(
        encoder=DeformableTransformerEncoder(
            embed_dim=d["embed"], num_heads=d["heads"], feedforward_dim=d["ffn"],
            num_layers=d["layers"], num_feature_levels=5, window_radius=window_radius),
        decoder=DeformableTransformerDecoder(
            embed_dim=d["embed"], num_heads=d["heads"], feedforward_dim=d["ffn"],
            num_layers=d["layers"], num_feature_levels=5, look_forward_twice=False),
        num_feature_levels=5, two_stage_num_proposals=d["queries"], assign_first_stage=True)
    return APEDeta(
        backbone=backbone, neck=ChannelMapper(out_channels=d["embed"], num_outs=5),
        transformer=transformer, embed_dim=d["embed"], embed_dim_language=d["ldim"],
        num_queries=d["queries"], in_features=levels, mask_in_feature=levels[0],
        **{"mask_on": False, **apedeta_kw})


def torch_tiny(d=DIMS, window_radius=4, scale_factors=PROTOCOL_SCALES, **apedeta_kw):
    """The port's APEDeta at the same dims and pyramid."""
    from ape_tpu_torch.modeling.ape_deta.model import APEDeta, ChannelMapper
    from ape_tpu_torch.modeling.ape_deta.transformer import (
        DeformableDetrTransformer,
        DeformableTransformerDecoder,
        DeformableTransformerEncoder,
    )
    from ape_tpu_torch.modeling.backbone.eva_vit import EVAViT, SimpleFeaturePyramid
    from ape_tpu_torch.modeling.build import pyramid_features

    sfp, levels = pyramid_features(scale_factors)
    backbone = SimpleFeaturePyramid(
        EVAViT(patch_size=16, embed_dim=d["vit_embed"], depth=d["vit_depth"],
               num_heads=d["vit_heads"], mlp_ratio=4 * 2 / 3, window_size=d["win"],
               window_block_indexes=(0,), pretrain_img_size=224, pt_hw_seq_len=16),
        out_channels=d["embed"], scale_factors=scale_factors)
    transformer = DeformableDetrTransformer(
        DeformableTransformerEncoder(d["embed"], d["heads"], d["ffn"], d["layers"], 5,
                                     window_radius=window_radius),
        DeformableTransformerDecoder(d["embed"], d["heads"], d["ffn"], d["layers"], 5),
        embed_dim=d["embed"], num_feature_levels=5, two_stage_num_proposals=d["queries"])
    return APEDeta(backbone, ChannelMapper(sfp, d["embed"], d["embed"], num_outs=5),
                   transformer, embed_dim=d["embed"], embed_dim_language=d["ldim"],
                   in_features=levels, mask_in_feature=levels[0],
                   **{"mask_on": False, **apedeta_kw})


def jax_tiny_protocol(d=DIMS, window_radius=4):
    """ape_tpu APEDeta at the parity-harness dims with the protocol pyramid."""
    return jax_tiny(d, window_radius)


def torch_tiny_protocol(d=DIMS, window_radius=4):
    """The port's APEDeta at the same dims."""
    return torch_tiny(d, window_radius)


def jax_tiny_masked(d=DIMS, window_radius=4, **kw):
    """ape_tpu APEDeta at the parity-harness dims as APE-Ti builds it by
    default: the 4-scale pyramid (levels p2 ... p6) and the mask head."""
    return jax_tiny(d, window_radius, MASKED_SCALES, mask_on=True, **kw)


def torch_tiny_masked(d=DIMS, window_radius=4, **kw):
    """The port's masked APEDeta at the same dims."""
    return torch_tiny(d, window_radius, MASKED_SCALES, mask_on=True, **kw)


def tiny_inputs(d=DIMS, seed=3, h=None, w=None):
    """Normalized, padded NHWC image (1, img, img, 3), sizes (1, 2), text
    features (1, T, ldim) with the last slot invalid, and text_valid."""
    rng = np.random.RandomState(seed)
    h = h or d["img"]
    w = w or d["img"]
    img = np.zeros((1, d["img"], d["img"], 3), np.float32)
    img[0, :h, :w] = rng.randn(h, w, 3)
    sizes = np.asarray([[h, w]], np.int32)
    text = rng.randn(1, d["num_text"] + 1, d["ldim"]).astype(np.float32)
    valid = np.arange(d["num_text"] + 1)[None] < d["num_text"]
    return img, sizes, text, valid
