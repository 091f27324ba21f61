"""The port's layers against ape_tpu's on the CPU, in f32 (atol 1e-4):
MultiScaleDeformableAttention in window mode (padded batch, grid
corrections) and exact mode (2- and 4-d references), MultiheadAttention,
FFN, MLP and VisionLanguageAlign."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ape_tpu.layers import common as j_common
from ape_tpu.layers import msda_module as j_msda
from ape_tpu.layers.align import VisionLanguageAlign as JAlign
from ape_tpu.modeling.ape_deta.transformer import (
    encoder_grid_corrections,
    encoder_reference_points,
)
from ape_tpu_torch.layers import msda_module
from ape_tpu_torch.layers.align import VisionLanguageAlign
from ape_tpu_torch.layers.common import FFN, MLP, MultiheadAttention
from tests.torch_parity import init_params, load_port

ATOL = 1e-4
SHAPES = ((8, 8), (4, 4), (2, 2))
C, HEADS = 32, 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _run(jm, pm, jax_prefix, torch_prefix, args, kwargs=None, points=4):
    """Apply both modules to the same numpy inputs with the same weights."""
    kwargs = kwargs or {}
    jx = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    tx = lambda a: _t(a) if isinstance(a, np.ndarray) else a
    jargs = [jx(a) for a in args]
    jkw = {k: jx(v) for k, v in kwargs.items()}
    flat, params = init_params(jm, *jargs, **jkw, heads=HEADS, points=points)
    want = np.asarray(jm.apply({"params": params}, *jargs, **jkw))
    load_port(pm, flat, jax_prefix, torch_prefix)
    with torch.no_grad():
        got = pm(*map(tx, args), **{k: tx(v) for k, v in kwargs.items()}).numpy()
    return got, want


def test_offset_ring_init():
    np.testing.assert_array_equal(msda_module._offset_bias_init(8, 5, 4),
                                  j_msda._offset_bias_init(8, 5, 4))
    m = msda_module.MultiScaleDeformableAttention(C, HEADS, 3, 2)
    np.testing.assert_array_equal(m.sampling_offsets.bias.detach().numpy(),
                                  j_msda._offset_bias_init(HEADS, 3, 2))


def test_msda_module_window_padded_batch(rng):
    s = sum(h * w for h, w in SHAPES)
    x = rng.randn(2, s, C).astype(np.float32)
    pos = rng.randn(2, s, C).astype(np.float32)
    ratios = jnp.asarray([[[1.0, 1.0]] * 3, [[0.75, 0.5], [0.75, 0.5], [1.0, 0.5]]])
    refs = np.asarray(encoder_reference_points(SHAPES, ratios))
    corr = np.asarray(encoder_grid_corrections(SHAPES, ratios))
    pad = np.zeros((2, s), bool)
    pad[1, ::5] = True
    kw = dict(query_pos=pos, key_padding_mask=pad, mode="window", grid_corrections=corr)
    got, want = _run(
        j_msda.MultiScaleDeformableAttention(C, HEADS, 3, 2, window_radius=2),
        msda_module.MultiScaleDeformableAttention(C, HEADS, 3, 2, window_radius=2),
        "transformer/encoder/layers_0/attn/", "transformer.encoder.layers.0.attentions.0.",
        (x, x, SHAPES, refs), kw, points=2)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msda_module_exact(rng, ref_dim):
    s = sum(h * w for h, w in SHAPES)
    q = rng.randn(2, 9, C).astype(np.float32)
    value = rng.randn(2, s, C).astype(np.float32)
    refs = rng.uniform(0.05, 0.95, (2, 9, 3, ref_dim)).astype(np.float32)
    if ref_dim == 4:
        refs[..., 2:] *= 0.4
    got, want = _run(
        j_msda.MultiScaleDeformableAttention(C, HEADS, 3, 2),
        msda_module.MultiScaleDeformableAttention(C, HEADS, 3, 2),
        "transformer/decoder/layers_0/cross_attn/", "transformer.decoder.layers.0.attentions.1.",
        (q, value, SHAPES, refs), dict(query_pos=rng.randn(2, 9, C).astype(np.float32),
                                       mode="exact"), points=2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_multihead_attention(rng):
    q = rng.randn(2, 11, C).astype(np.float32)
    pos = rng.randn(2, 11, C).astype(np.float32)
    got, want = _run(j_common.MultiheadAttention(C, HEADS), MultiheadAttention(C, HEADS),
                     "transformer/decoder/layers_0/self_attn/",
                     "transformer.decoder.layers.0.attentions.0.", (q,),
                     dict(query_pos=pos, key_pos=pos))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_ffn_and_mlp(rng):
    x = rng.randn(2, 7, C).astype(np.float32)
    got, want = _run(j_common.FFN(C, 64), FFN(C, 64), "transformer/encoder/layers_0/ffn/",
                     "transformer.encoder.layers.0.ffns.0.", (x,))
    np.testing.assert_allclose(got, want, atol=ATOL)
    got, want = _run(j_common.MLP(C, 4, 3), MLP(C, C, 4, 3), "transformer/decoder/bbox_embed_0/",
                     "transformer.decoder.bbox_embed.0.", (x,))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_vision_language_align(rng):
    x = rng.randn(2, 7, C).astype(np.float32)
    emb = rng.randn(2, 5, 24).astype(np.float32)
    got, want = _run(JAlign(C, 24), VisionLanguageAlign(C, 24), "class_embed_0/",
                     "class_embed.0.", (x, emb))
    assert got.shape == (2, 7, 5)
    np.testing.assert_allclose(got, want, atol=ATOL)
