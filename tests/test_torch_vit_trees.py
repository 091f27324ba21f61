"""The port's other ViT trees (ViTDet, EVA-01, ViT-E) against ape_tpu's on
the CPU, in f32 within 1e-4 unless said:

* ``get_rel_pos`` and ``add_decomposed_rel_pos`` against JAX's, the table
  rows exactly; a table of another length raises;
* tiny EVAViTs on a non-square input (a 6 x 5 token grid, so that a
  swapped h and w fails), each with one padded window and one global
  block: ViTDet-style (relative positions, GELU, no RoPE), ViT-E-style
  (post-norm and relative positions) and EVA-01-CLIP-style (GELU, neither);
  their relative-position tables drawn non-zero (JAX inits them to zeros);
  in f32, and in bf16 as far from JAX's bf16 output, and from the f32 one,
  as twice JAX's own bf16 error.

The tiny ViTDet-L APE-DETA and its train step are in
``tests/test_torch_vitdet_step.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.modeling.backbone import eva_vit as j_vit
from ape_tpu.modeling.backbone import vit_utils as j_utils
from ape_tpu_torch.modeling.backbone import eva_vit, vit_utils
from ape_tpu_torch.ops.bounds import bf16_steps
from tests.torch_parity import init_params, load_port, unflatten

ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("q_size,k_size", [(4, 4), (7, 7), (3, 5), (6, 2)])
def test_rel_pos_tables_match_ape_tpu(rng, q_size, k_size):
    table = rng.randn(2 * max(q_size, k_size) - 1, 8).astype(np.float32)
    got = vit_utils.get_rel_pos(q_size, k_size, _t(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_utils.get_rel_pos(q_size, k_size, jnp.asarray(table))))
    qh, qw, kh, kw = q_size, k_size, k_size, q_size  # a non-square query and key grid
    rel_h = rng.randn(2 * max(qh, kh) - 1, 8).astype(np.float32)
    rel_w = rng.randn(2 * max(qw, kw) - 1, 8).astype(np.float32)
    attn = rng.randn(3, qh * qw, kh * kw).astype(np.float32)
    q = rng.randn(3, qh * qw, 8).astype(np.float32)
    got = vit_utils.add_decomposed_rel_pos(_t(attn), _t(q), _t(rel_h), _t(rel_w), (qh, qw),
                                           (kh, kw))
    want = j_utils.add_decomposed_rel_pos(jnp.asarray(attn), jnp.asarray(q), jnp.asarray(rel_h),
                                          jnp.asarray(rel_w), (qh, qw), (kh, kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="relative-position table"):
        vit_utils.get_rel_pos(q_size, k_size, _t(table[1:]))


# The tiny trees: 48 wide, 3 heads of 16, block 0 windowed (windows of 4 over
# the 6 x 5 grid, padded to 8 x 8), block 1 global.
TINY = dict(patch_size=16, embed_dim=48, depth=2, num_heads=3, mlp_ratio=4 * 2 / 3,
            window_size=4, window_block_indexes=(0,), pretrain_img_size=224, pt_hw_seq_len=16,
            packed_swiglu=False)
STYLES = {
    "vitdet": dict(rope=False, use_rel_pos=True, mlp_type="gelu"),
    "vite": dict(rope=False, use_rel_pos=True, mlp_type="gelu", postnorm=True,
                 mlp_ratio=8.571428571428571),
    "eva01_clip": dict(rope=False, mlp_type="gelu", mlp_ratio=6144 / 1408),
}
IMG_HW = (96, 80)


def _tiny_tree(style):
    kw = {**TINY, **STYLES[style]}
    rng = np.random.RandomState(1)
    x = rng.randn(2, *IMG_HW, 3).astype(np.float32)
    jm = j_vit.EVAViT(img_size=1024, **kw)
    flat, _ = init_params(jm, jnp.asarray(x))
    rel = sorted(k for k in flat if "rel_pos" in k)
    for k in rel:  # drawn at the scale of the logits, so that a wrong index shows
        flat[k] = rng.normal(0.0, 0.5, flat[k].shape).astype(np.float32)
    assert all(np.abs(flat[k]).min() > 0 for k in rel)
    assert bool(rel) == kw.get("use_rel_pos", False)
    pm = load_port(eva_vit.EVAViT(img_size=IMG_HW, **kw), flat, "backbone/net/",
                   "backbone.net.")
    return x, jm, unflatten(flat), flat, pm


@pytest.mark.parametrize("style", list(STYLES))
def test_tiny_tree_on_a_non_square_input_matches_ape_tpu_in_f32(style):
    x, jm, params, flat, pm = _tiny_tree(style)
    if STYLES[style].get("use_rel_pos"):  # the global block's tables: 2 h - 1 and 2 w - 1 rows
        assert flat["blocks_1/attn/rel_pos_h"].shape[0] == 11
        assert flat["blocks_1/attn/rel_pos_w"].shape[0] == 9
        assert flat["blocks_0/attn/rel_pos_h"].shape[0] == 7
    assert not pm.blocks[1].attn.flash  # a global block on the plain product
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(_t(x)).numpy()
    assert got.shape == (2, 6, 5, 48)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("style", list(STYLES))
def test_tiny_tree_in_bf16_rounds_as_ape_tpu(style):
    """bf16 through both blocks: the port's output as far from JAX's bf16
    output, and from the f32 output, as twice JAX's own bf16 error."""
    x, jm, params, _, pm = _tiny_tree(style)
    f32 = torch.from_numpy(np.asarray(jm.apply({"params": params}, jnp.asarray(x))))
    jb = jm.clone(dtype=jnp.bfloat16)
    want = torch.from_numpy(np.asarray(
        jb.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)))
    with torch.no_grad():
        got = pm(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jax_err = float((want - f32).abs().max())
    assert bf16_steps(f32, 1) <= jax_err <= bf16_steps(f32, 8)
    assert float((got.float() - want).abs().max()) <= 2 * jax_err
    assert float((got.float() - f32).abs().max()) <= 2 * jax_err
