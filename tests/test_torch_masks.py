"""The port's masked APE-Ti against ape_tpu on the CPU, in f32: the weight
round trip over the masked tree, the pixel decoder and mask heads, the two
resizes (bilinear upsample of the encoder level, nearest GT resize), the
semantic and panoptic postprocessing, the APE wrapper's mask outputs, and the
mask losses with their gradients.

The model runs at the parity-harness dims (img 256, 2 + 2 layers, 60
queries) on APE-Ti's default 4-scale pyramid: levels p2 ... p6 of 64² ... 4²,
S = 5456 tokens, mask features at 64².
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.parity_harness import DIMS, FakeLanguage
from tests.torch_parity import (
    flatten,
    jax_tiny_masked,
    model_pair,
    tiny_inputs,
    torch_tiny_masked,
)

from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu.modeling.ape_deta import postprocess as j_post
from ape_tpu_torch.modeling.ape_deta import postprocess as post
from ape_tpu_torch.modeling.ape_deta.criterion import (
    DeformableCriterion,
    default_weight_dict,
    resize_nearest,
)
from ape_tpu_torch.modeling.ape_deta.model import upsample_bilinear

# Mask logits and features are sums over 64 channels of O(1) terms, so f32
# reordering moves them by ~1e-6 of their scale; held to 1e-4 of their
# largest entry. Logits and boxes as in test_torch_model.
MASK_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-6), (name, err)


def _pair(**kw):
    return model_pair(jax_tiny_masked(**kw), torch_tiny_masked(**kw))


@pytest.fixture(scope="module")
def masked_pair():
    """ape_tpu and port masked models at tiny dims with the same weights."""
    return _pair()


@pytest.mark.parametrize("tree", ["ti", "tiny_aux_mask"])
def test_weight_round_trip_masked_tree(tree):
    """Every key of a masked tree survives flax -> port -> flax exactly, and
    the port's model takes the state_dict strictly: APE-Ti as build_ape_ti
    makes it by default (shared mask_embed), and a tiny tree with one
    mask_embed per decoder layer."""
    from ape_tpu.checkpoint.convert import convert_torch_state_dict
    from ape_tpu.modeling.build import build_ape_ti as j_build
    from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
    from ape_tpu_torch.modeling.build import build_ape_ti

    if tree == "ti":
        jm, pm, size, ldim = j_build(img_size=64, num_queries=12), build_ape_ti(num_queries=12, device="cpu"), 64, 1024
    else:
        jm, pm, size, ldim = (jax_tiny_masked(aux_mask=True), torch_tiny_masked(aux_mask=True),
                              DIMS["img"], DIMS["ldim"])
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jnp.asarray([[size, size]]),
        jnp.zeros((1, 4, ldim)), jnp.ones((1, 4), bool)))["params"]
    rng = np.random.RandomState(0)
    flat = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flatten(shapes).items()}
    assert any(k.startswith("lateral_norm/") for k in flat)
    assert any(k.startswith("mask_embed_1/" if tree != "ti" else "mask_embed/") for k in flat)
    sd = state_dict_from_jax(flat)
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    pm.load_state_dict(sd, strict=True)


def _forward_pair(jm, params, pm, inputs, monkeypatch, train=False):
    """JAX's outputs with the first-stage indices it selected, and the port's."""
    import ape_tpu.modeling.ape_deta.transformer as jt

    selected = []
    select = jt.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    monkeypatch.setattr(jt, "deta_first_stage_select", recording_select)
    want = jax.jit(jm.apply)({"params": params}, *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        got = pm.train(train)(*(_t(a) for a in inputs))
    pm.eval()
    return want, got, selected[-1]


@pytest.mark.parametrize("case", ["full", "padded", "aux_mask", "encode_level_1"])
def test_masked_slice_matches_ape_tpu(masked_pair, monkeypatch, case):
    """pred_masks, mask_features, logits and boxes of the masked model: on a
    full and a padded image; with one mask_embed per layer (training mode,
    the auxiliary layers' masks too); and with the mask head on encoder level
    1, which the pixel decoder upsamples to the p2 map."""
    if case in ("full", "padded"):
        jm, params, _, pm = masked_pair
    else:
        kw = {"aux_mask": True} if case == "aux_mask" else {"mask_encode_level": 1}
        jm, params, _, pm = _pair(**kw)
    h, w = (200, 240) if case == "padded" else (256, 256)
    want, got, selected = _forward_pair(jm, params, pm, tiny_inputs(h=h, w=w), monkeypatch,
                                        train=case == "aux_mask")
    side = DIMS["img"] // 4
    assert got["pred_masks"].shape == (1, DIMS["queries"], side, side)
    assert got["mask_features"].shape == (1, side, side, DIMS["embed"])
    np.testing.assert_array_equal(got["first_stage_indices"].numpy(), selected)
    np.testing.assert_allclose(got["pred_logits"].numpy(), np.asarray(want["pred_logits"]), atol=1e-3)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]), atol=1e-4)
    _close(got["mask_features"].numpy(), want["mask_features"], MASK_RTOL, "mask_features")
    _close(got["pred_masks"].numpy(), want["pred_masks"], MASK_RTOL, "pred_masks")
    if case == "aux_mask":
        assert len(got["aux_outputs"]) == DIMS["layers"] - 1
        for i, (g, w_) in enumerate(zip(got["aux_outputs"], want["aux_outputs"])):
            _close(g["pred_masks"].numpy(), w_["pred_masks"], MASK_RTOL, f"aux {i} pred_masks")


@pytest.mark.parametrize("src,dst", [((7, 9), (16, 23)), ((16, 16), (64, 64)), ((5, 8), (5, 16))])
def test_upsample_bilinear_matches_jax_resize(src, dst):
    """Upsampling, the pixel decoder's only use, agrees with
    jax.image.resize(..., "bilinear"); a downsample is refused (JAX would
    antialias it)."""
    x = np.random.RandomState(1).randn(2, *src, 6).astype(np.float32)  # NHWC
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 6), method="bilinear")
    got = upsample_bilinear(_t(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError):
        upsample_bilinear(_t(x).permute(0, 3, 1, 2), (src[0] - 1, src[1]))


@pytest.mark.parametrize("src,dst", [((20, 28), (8, 10)), ((32, 32), (16, 16)), ((5, 6), (12, 9))])
def test_gt_resize_matches_jax_nearest(src, dst):
    """The GT mask resize picks JAX's pixels (half-pixel centres) at sizes
    where torch's plain "nearest" picks others."""
    m = np.random.RandomState(2).rand(2, 3, *src) > 0.5
    want = np.asarray(jax.image.resize(jnp.asarray(m, jnp.float32), (2, 3, *dst), method="nearest"))
    got = resize_nearest(_t(m).float(), dst).numpy()
    np.testing.assert_array_equal(got, want)
    floor_rule = torch.nn.functional.interpolate(_t(m).float(), size=dst, mode="nearest").numpy()
    assert not np.array_equal(floor_rule, want)


def _heads(rng, k=60, t=9, side=16):
    logits = (rng.randn(k, t) * 3 - 1).astype(np.float32)
    masks = (rng.randn(k, side, side) * 4).astype(np.float32)
    valid = np.arange(t) < t - 2
    return logits, masks, valid


@pytest.mark.parametrize("transform_eval", [True, False])
def test_semantic_and_panoptic_match(rng, transform_eval):
    logits, masks, valid = _heads(rng)
    want = j_post.semantic_inference(jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(valid),
                                     transform_eval=transform_eval)
    got = post.semantic_inference(_t(logits), _t(masks), _t(valid), transform_eval=transform_eval)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = j_post.panoptic_scores(jnp.asarray(logits), jnp.asarray(valid),
                                  transform_eval=transform_eval)
    got = post.panoptic_scores(_t(logits), _t(valid), transform_eval=transform_eval)
    for name, g, w in zip(("scores", "labels", "raw_scores"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("stuff_prob_thing", [-1.0, 0.3])
def test_get_stuff_score_matches(rng, stuff_prob_thing):
    logits, _, _ = _heads(rng)
    things = np.arange(logits.shape[1]) < 4
    want = j_post.get_stuff_score(jnp.asarray(logits), jnp.asarray(things), stuff_prob_thing)
    got = post.get_stuff_score(_t(logits), _t(things), stuff_prob_thing)
    assert got.shape == (logits.shape[0], logits.shape[1] + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_ape_wrapper_mask_outputs_match(masked_pair):
    """Instances with their mask logits, sem_seg and panoptic_raw through
    both wrappers, on the same weights and text features."""
    from ape_tpu.engine.ape_wrapper import APE as JAPE
    from ape_tpu_torch.engine.ape_wrapper import APE

    jm, params, _, pm = masked_pair
    img, sizes, _, _ = tiny_inputs(h=200, w=256)
    feats = np.random.RandomState(5).randn(DIMS["num_text"], DIMS["ldim"]).astype(np.float32)
    inputs = [{"image": img[0], "image_size": sizes[0], "text_prompt": "cat, dog, traffic_light"}]
    want = JAPE(jm, params, FakeLanguage(feats), panoptic_on=True)([dict(i) for i in inputs])[0]
    got = APE(pm, FakeLanguage(feats), panoptic_on=True)([dict(i) for i in inputs])[0]
    gi, wi = got["instances"], want["instances"]
    assert len(wi["scores"]) > 0
    np.testing.assert_array_equal(gi["classes"].numpy(), wi["classes"])
    np.testing.assert_allclose(gi["scores"].numpy(), wi["scores"], atol=1e-4)
    _close(gi["mask_logits"].numpy(), wi["mask_logits"], MASK_RTOL, "mask_logits")
    assert got["sem_seg"].shape == (128, DIMS["img"] // 4, DIMS["img"] // 4)
    np.testing.assert_allclose(got["sem_seg"].numpy(), want["sem_seg"], atol=1e-4)
    gp, wp = got["panoptic_raw"], want["panoptic_raw"]
    np.testing.assert_array_equal(gp["labels"].numpy(), wp["labels"])
    for k in ("scores", "raw_scores"):
        np.testing.assert_allclose(gp[k].numpy(), wp[k], atol=1e-4, err_msg=k)
    _close(gp["mask_logits"].numpy(), wp["mask_logits"], MASK_RTOL, "panoptic mask_logits")
    assert "sem_seg" not in APE(pm, FakeLanguage(feats), semantic_on=False)(inputs)[0]


@pytest.mark.parametrize("aux_mask", [False, True])
def test_mask_losses_and_grads_match(rng, aux_mask):
    """Every loss term and the gradient of the total with respect to the
    mask logits, against the JAX criterion, with GT masks at twice the mask
    resolution (so the nearest resize runs)."""
    from tests.test_torch_train import QUERIES, _jax_targets, _port_targets, _random_outputs, _tree

    out, tg = _random_outputs(rng)
    side = 16
    out["pred_masks"] = (rng.randn(2, QUERIES, side, side) * 3).astype(np.float32)
    if aux_mask:
        out["aux_outputs"][0]["pred_masks"] = (rng.randn(2, QUERIES, side, side) * 3).astype(np.float32)
    masks = rng.rand(*tg["valid"].shape, 2 * side, 2 * side) > 0.7
    nb = float(tg["valid"].sum())
    jcrit = j_criterion.DeformableCriterion(num_classes=out["pred_logits"].shape[-1],
                                            num_queries=QUERIES,
                                            weight_dict=j_criterion.default_weight_dict())

    def jax_total(pred_masks, aux_masks):
        o = _tree(out, jnp.asarray)
        o["pred_masks"] = pred_masks
        if aux_mask:
            o["aux_outputs"][0]["pred_masks"] = aux_masks
        losses = jcrit(jax.random.PRNGKey(0), o, dict(_jax_targets(tg), masks=jnp.asarray(masks)),
                       jnp.asarray(nb))
        return jcrit.total(losses), losses

    aux_in = jnp.asarray(out["aux_outputs"][0].get("pred_masks", np.zeros(1, np.float32)))
    (want_total, want), (want_g, want_aux_g) = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(jnp.asarray(out["pred_masks"]), aux_in)

    crit = DeformableCriterion(num_classes=out["pred_logits"].shape[-1], num_queries=QUERIES,
                               weight_dict=default_weight_dict())
    port_out = _tree(out, _t)
    leaves = [port_out["pred_masks"].requires_grad_()]
    if aux_mask:
        leaves.append(port_out["aux_outputs"][0]["pred_masks"].requires_grad_())
    got = crit(port_out, dict(_port_targets(tg), masks=_t(masks)), torch.tensor(nb))
    assert sorted(got) == sorted(want)  # jax.value_and_grad returns the dict key-sorted
    assert ("loss_mask_0" in got) == aux_mask and "loss_dice" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    total = crit.total(got)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    grads = torch.autograd.grad(total, leaves)
    _close(grads[0].numpy(), want_g, 1e-4, "d pred_masks")
    assert float(np.abs(np.asarray(want_g)).max()) > 0
    if aux_mask:
        _close(grads[1].numpy(), want_aux_g, 1e-4, "d aux pred_masks")
