"""The port's ViT backbone against ape_tpu's on the CPU, in f32 (atol 1e-4):
vit_utils, EVAViT with windowed (padded) and global blocks, under each of
EVA-01's and ViT-E's flags too, and the
SimpleFeaturePyramid at the protocol scales and at the full four scales
(the latter runs the ConvTranspose kernel flip twice)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ape_tpu.modeling.backbone import eva_vit as j_vit
from ape_tpu.modeling.backbone import vit_utils as j_utils
from ape_tpu_torch.modeling.backbone import eva_vit, vit_utils
from tests.torch_parity import PROTOCOL_SCALES, init_params, load_port

ATOL = 1e-4
VIT = dict(patch_size=16, embed_dim=48, depth=3, num_heads=3,
           mlp_ratio=4 * 2 / 3, window_size=4, window_block_indexes=(0, 1),
           pretrain_img_size=224, pt_hw_seq_len=16)


def test_window_partition_roundtrip_with_padding(rng):
    x = rng.randn(2, 6, 7, 5).astype(np.float32)
    got, pad_hw = vit_utils.window_partition(torch.from_numpy(x), 4)
    want, want_pad = j_utils.window_partition(jnp.asarray(x), 4)
    assert pad_hw == want_pad == (8, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = vit_utils.window_unpartition(got, 4, pad_hw, (6, 7))
    np.testing.assert_array_equal(back.numpy(), x)


def test_rope_and_bicubic_tables(rng):
    cos, sin = vit_utils.rope_2d_table(8, 6, 16)
    jcos, jsin = j_utils.rope_2d_table(8, 6, 16)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    x = rng.randn(2, 3, 36, 16).astype(np.float32)
    got = vit_utils.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    want = j_utils.apply_rope(jnp.asarray(x), jnp.asarray(jcos), jnp.asarray(jsin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(vit_utils.bicubic_resize_matrix(14, 6),
                                  j_utils.bicubic_resize_matrix(14, 6))
    pos = rng.randn(1, 197, 8).astype(np.float32)
    got = vit_utils.resize_abs_pos(torch.from_numpy(pos), True, (6, 9))
    want = j_utils.resize_abs_pos(jnp.asarray(pos), True, (6, 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_eva_vit_windowed_and_global_blocks(rng):
    x = rng.randn(1, 96, 96, 3).astype(np.float32)
    jm = j_vit.EVAViT(packed_swiglu=True, **VIT)
    flat, params = init_params(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = load_port(eva_vit.EVAViT(**VIT), flat, "backbone/net/", "backbone.net.")
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 6, 6, 48)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("flag", [dict(use_rel_pos=True), dict(postnorm=True),
                                  dict(mlp_type="gelu")], ids=["rel_pos", "postnorm", "gelu"])
def test_eva_vit_takes_other_flags(rng, flag):
    """EVA-01's relative positions (here under RoPE: the terms read the
    rotated, unscaled q) and GELU MLP and ViT-E's post-norm, each alone on
    the windowed and global blocks, match JAX's (the rest:
    tests/test_torch_vit_trees.py)."""
    x = rng.randn(1, 96, 96, 3).astype(np.float32)
    jm = j_vit.EVAViT(packed_swiglu=True, **flag, **VIT)
    flat, params = init_params(jm, jnp.asarray(x))
    assert all(np.abs(v).min() > 0 for k, v in flat.items() if "rel_pos" in k)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = load_port(eva_vit.EVAViT(img_size=96, **flag, **VIT), flat, "backbone/net/",
                   "backbone.net.")
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("scales", [PROTOCOL_SCALES, (4.0, 2.0, 1.0, 0.5)])
def test_simple_feature_pyramid(rng, scales):
    x = rng.randn(1, 96, 96, 3).astype(np.float32)
    jm = j_vit.SimpleFeaturePyramid(net=j_vit.EVAViT(packed_swiglu=True, **VIT),
                                    out_channels=32, scale_factors=scales)
    flat, params = init_params(jm, jnp.asarray(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    pm = eva_vit.SimpleFeaturePyramid(eva_vit.EVAViT(**VIT), out_channels=32, scale_factors=scales)
    load_port(pm, flat, "backbone/", "backbone.")
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].shape == arr.shape, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(arr), atol=ATOL, err_msg=name)
