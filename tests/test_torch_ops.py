"""ape_tpu_torch.ops against ape_tpu.ops on the CPU, in f32: values, and the
gradients of the kernel ops (torch autograd of the plain versions, which the
CUDA backward kernels are held to on the card) against JAX's VJPs.

The MSDA window path is held against ``ms_deform_attn_window_dispatch``,
which on the CPU is the exact clip-then-gather bridge, and once against the
Pallas kernel itself in interpret mode (its value planes are bf16, hence the
looser bound there). Kernel wrappers given CPU tensors take their plain
versions and launch nothing; the kernels themselves are tested in
``test_torch_kernels.py`` on a CUDA machine.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ape_tpu.modeling.ape_deta.transformer import encoder_grid_corrections
from ape_tpu.ops import box_ops as j_box_ops
from ape_tpu.ops.box_ops import box_cxcywh_to_xyxy as j_box
from ape_tpu.ops.misc import inverse_sigmoid as j_inverse_sigmoid
from ape_tpu.ops.misc import sigmoid_focal_loss as j_focal
from ape_tpu.ops.msda_decoder import ms_deform_attn_decoder
from ape_tpu.ops.msda_dispatch import ms_deform_attn_window_dispatch
from ape_tpu.ops.nms import batched_nms_mask as j_batched_nms
from ape_tpu.ops.nms import nms_mask as j_nms
from ape_tpu.ops.posemb import position_embedding_sine as j_posemb
from ape_tpu_torch.ops import _build, box_ops
from ape_tpu_torch.ops.attention import global_attention, global_attention_plain
from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy
from ape_tpu_torch.ops.misc import inverse_sigmoid, sigmoid_focal_loss
from ape_tpu_torch.ops.msda import ms_deform_attn
from ape_tpu_torch.ops.msda_dispatch import ms_deform_attn_exact, ms_deform_attn_window
from ape_tpu_torch.ops.nms import batched_nms_mask, nms_mask
from ape_tpu_torch.ops.posemb import position_embedding_sine

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def test_box_cxcywh_to_xyxy(rng):
    boxes = rng.rand(3, 17, 4).astype(np.float32)
    np.testing.assert_allclose(box_cxcywh_to_xyxy(_t(boxes)).numpy(),
                               np.asarray(j_box(jnp.asarray(boxes))), atol=ATOL)


def test_inverse_sigmoid(rng):
    x = np.concatenate([rng.uniform(-0.2, 1.2, 200), [0.0, 1.0, 1e-4, 1 - 1e-4]]).astype(np.float32)
    np.testing.assert_allclose(inverse_sigmoid(_t(x)).numpy(),
                               np.asarray(j_inverse_sigmoid(jnp.asarray(x))), atol=ATOL)


def test_position_embedding_sine_padded():
    mask = np.zeros((2, 6, 7), bool)
    mask[0] = True
    mask[1, :4, :5] = True
    got = position_embedding_sine(_t(mask), num_pos_feats=16).numpy()
    want = np.asarray(j_posemb(jnp.asarray(mask), num_pos_feats=16))
    assert got.shape == (2, 6, 7, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _random_boxes(rng, n):
    xy = rng.rand(n, 2) * 0.8
    return np.concatenate([xy, xy + 0.02 + rng.rand(n, 2) * 0.3], 1).astype(np.float32)


@pytest.mark.parametrize("n,thresh", [(7, 0.5), (600, 0.5), (1000, 0.9)])
def test_nms_mask_identical(rng, n, thresh):
    boxes = _random_boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    scores[: n // 10] = scores[n // 10 : 2 * (n // 10)]  # ties keep index order
    valid = rng.rand(n) > 0.1
    want = np.asarray(j_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh, jnp.asarray(valid)))
    got = nms_mask(_t(boxes), _t(scores), thresh, _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_nms_mask_leading_batch_and_classes(rng):
    """A leading batch runs independent problems (the per-level first-stage
    select); the class-aware form offsets boxes per class."""
    boxes = np.stack([_random_boxes(rng, 300) for _ in range(3)])
    scores = rng.rand(3, 300).astype(np.float32)
    got = nms_mask(_t(boxes), _t(scores), 0.6).numpy()
    for g in range(3):
        want = np.asarray(j_nms(jnp.asarray(boxes[g]), jnp.asarray(scores[g]), 0.6))
        np.testing.assert_array_equal(got[g], want)
    classes = rng.randint(0, 4, 300)
    want = np.asarray(j_batched_nms(jnp.asarray(boxes[0] * 100), jnp.asarray(scores[0]),
                                    jnp.asarray(classes), 0.5))
    got = batched_nms_mask(_t(boxes[0] * 100), _t(scores[0]), _t(classes), 0.5).numpy()
    np.testing.assert_array_equal(got, want)


def _msda_inputs(rng, shapes, b=1, heads=2, d=8, p=2, max_off=3.0):
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    value = rng.randn(b, s, heads, d).astype(np.float32)
    off = rng.uniform(-max_off, max_off, (b, s, heads, l, p, 2)).astype(np.float32)
    w = rng.rand(b, s, heads, l, p).astype(np.float32)
    w /= w.reshape(b, s, heads, -1).sum(-1)[..., None, None]
    return value, off, w


@pytest.mark.parametrize("shapes,radius,max_off", [
    (((8, 8),), 2, 3.0),  # same-resolution pair, offsets past the window
    (((8, 8), (4, 4), (2, 2)), 2, 3.0),  # finer and coarser level pairs
    (((6, 10), (3, 5)), 4, 9.0),  # non-square levels, taps far out of range
])
def test_msda_window_matches_dispatch(rng, shapes, radius, max_off):
    value, off, w = _msda_inputs(rng, shapes, max_off=max_off)
    want = ms_deform_attn_window_dispatch(jnp.asarray(value), shapes, jnp.asarray(off),
                                          jnp.asarray(w), radius=radius)
    got = ms_deform_attn_window(_t(value), shapes, _t(off), _t(w), radius)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_msda_window_padded_batch_grid_corrections(rng):
    """A padded batch: the valid-ratio shift enters the offsets as grid
    corrections (non-zero for the padded image) before the clip."""
    shapes = ((8, 8), (4, 4), (2, 2))
    value, off, w = _msda_inputs(rng, shapes, b=2)
    ratios = np.asarray([[[1.0, 1.0]] * 3, [[0.75, 0.5], [0.75, 0.5], [1.0, 0.5]]], np.float32)
    corr = np.asarray(encoder_grid_corrections(shapes, jnp.asarray(ratios)))
    assert np.abs(corr[1]).max() > 1.0 and np.abs(corr[0]).max() == 0.0
    off = off + corr[:, :, None, :, None, :]
    want = ms_deform_attn_window_dispatch(jnp.asarray(value), shapes, jnp.asarray(off),
                                          jnp.asarray(w), radius=2)
    got = ms_deform_attn_window(_t(value), shapes, _t(off), _t(w), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_msda_exact_matches_decoder(rng):
    shapes = ((8, 8), (4, 4), (2, 2))
    value, _, _ = _msda_inputs(rng, shapes, b=2)
    loc = rng.uniform(-0.2, 1.2, (2, 11, 2, 3, 2, 2)).astype(np.float32)
    w = rng.rand(2, 11, 2, 3, 2).astype(np.float32)
    want = ms_deform_attn_decoder(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w))
    got = ms_deform_attn_exact(_t(value), shapes, _t(loc), _t(w))
    assert got.shape == (2, 11, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_msda_window_matches_pallas_kernel(rng):
    """Against the TPU kernel itself, run in interpret mode."""
    from ape_tpu.ops.msda_window_pallas_v2 import ms_deform_attn_window_pallas_v2

    shapes = ((8, 8), (4, 4))
    value, off, w = _msda_inputs(rng, shapes, max_off=4.0)
    want = ms_deform_attn_window_pallas_v2(jnp.asarray(value), shapes, jnp.asarray(off),
                                           jnp.asarray(w), radius=2, interpret=True)
    got = ms_deform_attn_window(_t(value), shapes, _t(off), _t(w), 2)
    # the kernel's value planes are bf16 (tests/test_msda_pallas.py bound)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 2e-2


@pytest.mark.parametrize("n,dh", [(256, 32), (200, 64)])
def test_global_attention_matches_jax_einsum(rng, n, dh):
    """The plain version against the einsum path JAX runs off the TPU
    (eva_vit.Attention without flash attention)."""
    import jax

    q, k, v = (rng.randn(2, 3, n, dh).astype(np.float32) for _ in range(3))
    scale = dh**-0.5
    attn = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q) * scale, jnp.asarray(k))
    attn = jax.nn.softmax(attn.astype(jnp.float32), axis=-1)
    want = jnp.einsum("bhqk,bhkd->bhqd", attn, jnp.asarray(v))
    got = global_attention(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrappers_take_plain_path_on_cpu(rng):
    """CPU tensors go to the plain versions and launch no kernel."""
    _build.reset_launches()
    shapes = ((4, 4), (2, 2))
    value, off, w = _msda_inputs(rng, shapes)
    loc = rng.rand(1, 5, 2, 2, 2, 2).astype(np.float32)
    w2 = rng.rand(1, 5, 2, 2, 2).astype(np.float32)
    np.testing.assert_array_equal(ms_deform_attn_exact(_t(value), shapes, _t(loc), _t(w2)).numpy(),
                                  ms_deform_attn(_t(value), shapes, _t(loc), _t(w2)).numpy())
    ms_deform_attn_window(_t(value), shapes, _t(off), _t(w), 2)
    q = _t(rng.randn(1, 2, 10, 32).astype(np.float32))
    np.testing.assert_array_equal(global_attention(q, q, q, 0.1).numpy(),
                                  global_attention_plain(q, q, q, 0.1).numpy())
    assert set(_build.LAUNCHES.values()) == {0}



@pytest.mark.parametrize("fn", ["box_iou", "generalized_box_iou", "elementwise_box_iou",
                                "elementwise_generalized_box_iou"])
def test_box_iou_family(rng, fn):
    a = box_cxcywh_to_xyxy(_t(rng.rand(2, 9, 4).astype(np.float32) * 0.6 + 0.05)).numpy()
    b = box_cxcywh_to_xyxy(_t(rng.rand(2, 9, 4).astype(np.float32) * 0.6 + 0.05)).numpy()
    want = getattr(j_box_ops, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(box_ops, fn)(_t(a), _t(b))
    want, got = (want, got) if isinstance(got, tuple) else ((want,), (got,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("alpha", [0.25, -1.0])
def test_sigmoid_focal_loss(rng, alpha):
    logits = (rng.randn(4, 30) * 4).astype(np.float32)
    targets = (rng.rand(4, 30) > 0.8).astype(np.float32)
    want = j_focal(jnp.asarray(logits), jnp.asarray(targets), alpha, 2.0)
    np.testing.assert_allclose(sigmoid_focal_loss(_t(logits), _t(targets), alpha, 2.0).numpy(),
                               np.asarray(want), atol=ATOL)


def _vjp_check(port_fn, jax_fn, inputs, cotangent, atol):
    """Port gradients (torch autograd) against jax.vjp at the same point."""
    import jax

    want_out, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in inputs))
    want = vjp(jnp.asarray(cotangent))
    leaves = [_t(x).requires_grad_() for x in inputs]
    out = port_fn(*leaves)
    got = torch.autograd.grad(out, leaves, _t(cotangent))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, err_msg=f"input {i}")


# Gradients sum many products in another order than XLA: 1e-4 absolute on
# gradients of order 1-10 (d_loc carries a factor of the level size).
GRAD_ATOL = 1e-4


@pytest.mark.parametrize("shapes,radius,max_off", [
    (((8, 8), (4, 4), (2, 2)), 2, 3.0),  # offsets past the window: the clip's zero gradient
    (((6, 10), (3, 5)), 4, 2.0),  # non-square levels, inside the window
])
def test_msda_window_grad_matches_jax(rng, shapes, radius, max_off):
    value, off, w = _msda_inputs(rng, shapes, b=2, max_off=max_off)
    g = rng.randn(2, value.shape[1], value.shape[2] * value.shape[3]).astype(np.float32)
    _vjp_check(
        lambda v, o, a: ms_deform_attn_window(v, shapes, o, a, radius),
        lambda v, o, a: ms_deform_attn_window_dispatch(v, shapes, o, a, radius=radius,
                                                       force_impl="exact"),
        (value, off, w), g, GRAD_ATOL)


def test_msda_decoder_grad_matches_jax(rng):
    """Against the decoder's custom backward (_dec_bwd: gather VJP for loc and
    att, dense matmuls for value)."""
    shapes = ((8, 8), (4, 4), (2, 2))
    value, _, _ = _msda_inputs(rng, shapes, b=2)
    loc = rng.uniform(-0.1, 1.1, (2, 11, 2, 3, 2, 2)).astype(np.float32)
    w = rng.rand(2, 11, 2, 3, 2).astype(np.float32)
    g = rng.randn(2, 11, 16).astype(np.float32)
    _vjp_check(lambda v, l, a: ms_deform_attn_exact(v, shapes, l, a),
               lambda v, l, a: ms_deform_attn_decoder(v, shapes, l, a),
               (value, loc, w), g, GRAD_ATOL)


@pytest.mark.parametrize("n,dh", [(100, 32), (64, 64)])
def test_global_attention_grad_matches_jax(rng, n, dh):
    import jax

    scale = dh**-0.5

    def jax_attn(q, k, v):
        attn = jnp.einsum("bhqd,bhkd->bhqk", q * scale, k)
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(attn, axis=-1), v)

    q, k, v, g = (rng.randn(2, 3, n, dh).astype(np.float32) for _ in range(4))
    _vjp_check(lambda a, b, c: global_attention(a, b, c, scale), jax_attn, (q, k, v), g, GRAD_ATOL)
