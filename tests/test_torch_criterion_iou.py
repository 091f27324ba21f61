"""The rest of JAX's criterion in the port, against ape_tpu on the CPU in f32:
the encoder's IoU regressions (``pred_iou``, ``anchor_iou`` ->
``loss_iou_enc``), the point-sampled ``masks_maskdino`` loss (with the same
points injected into both, since the two RNGs differ, and each drawing its
own), ``boxes_panoptic``; that ``PORTED`` covers every loss name JAX's
criterion dispatches on, and that the IoU-loss configs build through the
port's model zoo."""

import inspect
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_config_tree import ROOT

from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu_torch.modeling.ape_deta import criterion as p_criterion
from ape_tpu_torch.modeling.ape_deta.criterion import PORTED, DeformableCriterion

QUERIES = 40
NUM_TEXT = 6
WEIGHTS = {"loss_class": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0, "loss_mask": 5.0,
           "loss_dice": 5.0, "loss_iou": 1.0, "loss_mask_maskdino": 5.0,
           "loss_dice_maskdino": 5.0}
IOU_CONFIGS = ("configs/LVIS_SA1B_InstanceSegmentation/ape_deta/ape_deta_r50_50ep_iouloss_lp.py",
               "configs/LVIS_SA1B_InstanceSegmentation/ape_deta/ape_deta_vitl_iouloss_lp_mdl.py")


def _boxes(rng, *lead):
    return np.concatenate([rng.uniform(0.2, 0.8, (*lead, 2)), rng.uniform(0.05, 0.3, (*lead, 2))],
                          -1).astype(np.float32)


def _case(rng, b=2, g=5, s=300, side=16, gt_side=24):
    """Model-shaped outputs (a final and an auxiliary layer with masks, the
    encoder's proposals) whose references and anchors copy some gts, and
    the targets with masks at another resolution than the predictions'."""
    gt = _boxes(rng, b, g)
    valid = np.arange(g)[None].repeat(b, 0) < np.array([[4], [3]])
    refs, anchors = _boxes(rng, b, QUERIES), _boxes(rng, b, s)
    for i in range(b):
        for j in range(3):
            refs[i, 3 * j] = gt[i, j] + rng.normal(0, 0.01, 4)
            anchors[i, 5 * j] = gt[i, j] + rng.normal(0, 0.01, 4)
    jitter = lambda x: np.clip(x + rng.normal(0, 0.02, x.shape), 0.01, 0.99).astype(np.float32)  # noqa: E731

    def head():
        return {"pred_logits": rng.randn(b, QUERIES, NUM_TEXT).astype(np.float32) * 2,
                "pred_boxes": jitter(refs),
                "pred_masks": rng.randn(b, QUERIES, side, side).astype(np.float32) * 3}

    out = {**head(), "aux_outputs": [head()], "init_reference": refs,
           "enc_outputs": {"pred_logits": rng.randn(b, s, 1).astype(np.float32),
                           "pred_boxes": jitter(anchors), "anchors": anchors,
                           "valid": rng.rand(b, s) > 0.1}}
    targets = {"labels": rng.randint(0, NUM_TEXT, (b, g)).astype(np.int32), "boxes": gt,
               "valid": valid, "masks": (rng.rand(b, g, gt_side, gt_side) > 0.6).astype(np.float32),
               "is_thing": rng.rand(b, g) > 0.4}
    return out, targets


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, fn) for v in x]
    return fn(x)


def _port_targets(tg):
    t = _tree(tg, lambda v: torch.from_numpy(np.array(v)))
    return {**t, "labels": t["labels"].long()}


def _both(out, tg, generator=None, **kw):
    """(JAX's losses, the port's) of one criterion call, num_boxes alike."""
    nb = float(tg["valid"].sum())
    jcrit = j_criterion.DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                                            weight_dict=WEIGHTS, **kw)
    want = jcrit(jax.random.PRNGKey(0), _tree(out, jnp.asarray),
                 _tree(tg, jnp.asarray), jnp.asarray(nb))
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES, weight_dict=WEIGHTS,
                               **kw)
    got = crit(_tree(out, lambda v: torch.from_numpy(np.array(v))), _port_targets(tg),
               torch.tensor(nb), None, generator)
    return want, got, jcrit, crit


def _assert_close(want, got):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("loss", ["pred_iou", "anchor_iou"])
def test_iou_losses_match(rng, loss):
    """``loss_iou_enc`` under each IoU regression, beside every other term,
    and its weight in the total."""
    out, tg = _case(rng)
    want, got, jcrit, crit = _both(out, tg, losses=("class", "boxes", loss))
    assert "loss_iou_enc" in got and float(got["loss_iou_enc"]) > 0
    _assert_close(want, got)
    np.testing.assert_allclose(float(crit.total(got)), float(jcrit.total(want)), rtol=1e-5)


def test_boxes_panoptic_matches(rng):
    """The box losses over the matched "thing" targets."""
    out, tg = _case(rng)
    want, got, _, _ = _both(out, tg, losses=("class", "boxes_panoptic"))
    plain = _both(out, tg, losses=("class", "boxes"))[1]
    assert float(got["loss_bbox"]) < float(plain["loss_bbox"])
    _assert_close(want, got)


def _inject_points(monkeypatch, rng, b, m, n_over, n_rand):
    """The same uniform points for JAX (its two ``jax.random.uniform`` draws,
    by shape) and the port (``draw_points``)."""
    pts = rng.rand(b, m, n_over, 2).astype(np.float32)
    fresh = rng.rand(b, m, n_rand, 2).astype(np.float32)
    by_shape = {pts.shape: pts, fresh.shape: fresh}
    uniform = jax.random.uniform

    def fake_uniform(key, shape=(), *a, **k):
        shape = tuple(shape)
        return jnp.asarray(by_shape[shape]) if shape in by_shape else uniform(key, shape, *a, **k)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(p_criterion, "draw_points",
                        lambda *a, **k: (torch.from_numpy(pts), torch.from_numpy(fresh)))


@pytest.mark.parametrize("max_masks", [4, 64])
def test_point_sampled_masks_match(rng, monkeypatch, max_masks):
    """The point-sampled ``masks_maskdino`` loss of the final and the
    auxiliary layer on injected points: every term within 1e-5, with the
    matched queries compacted into fewer slots than they fill (4) and into
    more (64, past the queries: min(max_masks, K))."""
    out, tg = _case(rng)
    kw = dict(losses=("class", "boxes", "masks_maskdino"), mask_point_sample=True,
              mask_num_points=96, mask_max_masks=max_masks)
    _inject_points(monkeypatch, rng, 2, min(max_masks, QUERIES), 288, 24)
    want, got, _, _ = _both(out, tg, **kw)
    for k in ("loss_mask_maskdino", "loss_dice_maskdino", "loss_mask_maskdino_0",
              "loss_dice_maskdino_0"):
        assert float(got[k]) > 0, k
    _assert_close(want, got)


def test_point_sampled_masks_gradient_matches(rng, monkeypatch):
    """The gradient of the point-sampled loss with respect to the mask
    logits, against ``jax.grad``, on injected points."""
    out, tg = _case(rng, side=12, gt_side=12)
    _inject_points(monkeypatch, rng, 2, 8, 96, 8)
    kw = dict(num_classes=NUM_TEXT, num_queries=QUERIES, weight_dict=WEIGHTS,
              losses=("masks_maskdino",), mask_point_sample=True, mask_num_points=32,
              mask_max_masks=8)
    assign = np.full((2, QUERIES), -1, np.int64)
    assign[0, [1, 5, 9]] = [0, 1, 2]
    assign[1, [0, 7]] = [1, 0]
    jcrit = j_criterion.DeformableCriterion(**kw)

    def jloss(pm):
        res = jcrit.loss_masks_maskdino({"pred_masks": pm}, _tree(tg, jnp.asarray),
                                        jnp.asarray(assign), 5.0, jax.random.PRNGKey(0))
        return res["loss_mask_maskdino"] + res["loss_dice_maskdino"]

    want = np.asarray(jax.grad(jloss)(jnp.asarray(out["pred_masks"])))
    pm = torch.from_numpy(out["pred_masks"]).requires_grad_(True)
    crit = DeformableCriterion(**kw)
    res = crit.loss_masks_maskdino({"pred_masks": pm}, _port_targets(tg), torch.from_numpy(assign),
                                   5.0, p_criterion.draw_points(2, 8, 96, 8, None, "cpu"))
    (res["loss_mask_maskdino"] + res["loss_dice_maskdino"]).backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(pm.grad.numpy(), want, atol=1e-7, rtol=1e-4)


def test_point_sampled_masks_draw_their_own_points(rng):
    """Without injection each side draws its points (JAX's from its key,
    the port's from the step's generator): both run, give every term
    finite, and the port's generator path repeats under one seed and moves
    under another."""
    out, tg = _case(rng)
    kw = dict(losses=("class", "boxes", "masks_maskdino"), mask_point_sample=True,
              mask_num_points=64, mask_max_masks=16)
    want, got, _, _ = _both(out, tg, torch.Generator().manual_seed(0), **kw)
    assert list(got) == list(want)
    assert all(np.isfinite(float(v)) for v in list(want.values()) + list(got.values()))
    again = _both(out, tg, torch.Generator().manual_seed(0), **kw)[1]
    other = _both(out, tg, torch.Generator().manual_seed(1), **kw)[1]
    assert float(again["loss_mask_maskdino"]) == float(got["loss_mask_maskdino"])
    assert float(other["loss_mask_maskdino"]) != float(got["loss_mask_maskdino"])


def test_ported_covers_jax_losses():
    """Every loss name JAX's criterion dispatches on is ported, and none is
    refused."""
    src = inspect.getsource(j_criterion.DeformableCriterion.__call__)
    names = set(re.findall(r'"(\w+)" in self\.losses', src))
    assert names >= {"class", "boxes", "boxes_panoptic", "masks", "masks_maskdino", "pred_iou",
                     "anchor_iou"}
    assert names <= set(PORTED)
    DeformableCriterion(num_classes=3, weight_dict={}, losses=tuple(names),
                        mask_point_sample=True)


@pytest.mark.parametrize("config", IOU_CONFIGS)
def test_iou_configs_build(config):
    """Both IoU-regression recipes build through the port's model zoo: the
    model's structure and every group's criterion, the point-sampling sizes
    and the losses taken from the config."""
    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.model_zoo import build_criterion, build_model

    cfg = LazyConfig.load(str(ROOT / config))
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) > 1e7
    crits = [build_criterion(cfg, i) for i in range(len(cfg.criterions))]
    assert len(crits) >= 2 and crits[0].mask_num_points == 12544
    if "vitl" in config:
        assert "pred_iou" in crits[0].losses and crits[0].weight_dict["loss_iou"] == 1.0
