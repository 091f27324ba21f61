"""The port's R50 family in training against ape_tpu on the CPU, in f32:

* the criterion with ``use_stage2=False`` (the Deformable-DETR R50
  recipes: every decoder layer matched by the Hungarian, losses class and
  boxes, weights 2 / 5 / 2) against JAX's, with the single-stage model's
  placeholder first stage and with real anchors: every loss term within
  1e-5;
* one train step of APE-DETA R50 (masked), its fusion tree under
  recompute and DETA R50's class bank (tests/torch_parity.R50_TREES;
  Deformable-DETR R50's in tests/test_torch_r50_detr_train.py) against JAX's
  ``make_train_step``, its gradients read off a recording optimizer: every
  loss term, the total, and every parameter's gradient (a parameter the
  port leaves without one, the stem behind ``freeze_at``, counts as zero,
  JAX's value there);
(tests/test_torch_r50_detr_train.py: Deformable-DETR R50's steps and the
R50 recipe's optimizer.)
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.engine import train_step as j_train_step
from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.engine.train_step import loss_fn
from ape_tpu_torch.modeling.ape_deta import matchers
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from tests.test_torch_l_d_train import _recording_tx
from tests.test_torch_train import (
    GRAD_RTOL,
    LOSS_ATOL,
    _jax_targets,
    _port_batch,
    _port_targets,
    _positives,
    _targets,
)
from tests.torch_parity import (
    R50_DIMS,
    R50_TREES,
    flatten,
    jax_tiny_r50,
    model_pair,
    tiny_inputs,
    torch_tiny_r50,
)

QUERIES = R50_DIMS["queries"]
STAGE2_CAP = int(QUERIES * 0.25)
DETR_WEIGHTS = {"loss_class": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0}


def _t(x):
    return torch.from_numpy(np.array(x))


def _criterion_kw(tree: str, num_classes: int):
    """The recipe's criterion of a tree: Deformable-DETR R50's Hungarian on
    every layer, class and boxes at 2 / 5 / 2; else DETA's, with masks on a
    masked tree."""
    kw = dict(num_classes=num_classes, num_queries=QUERIES)
    if tree.startswith("detr"):
        return dict(kw, use_stage2=False, losses=("class", "boxes"), weight_dict=DETR_WEIGHTS)
    masks = R50_TREES[tree][1].get("mask_on", False)
    return dict(kw, losses=("class", "boxes", "masks") if masks else ("class", "boxes"),
                weight_dict=default_weight_dict())


def _heads(rng, b, k, c):
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, k, 2)), rng.uniform(0.05, 0.4, (b, k, 2))], -1)
    return {"pred_logits": rng.randn(b, k, c).astype(np.float32) - 2.0,
            "pred_boxes": boxes.astype(np.float32)}


@pytest.mark.parametrize("enc", ["placeholder", "anchors"])
def test_use_stage2_false_losses_match_jax(rng, enc):
    """The Deformable-DETR R50 criterion (Hungarian on the final and two aux
    layers, the first stage's stage1 assignment) against JAX's on the same
    outputs: every loss term within LOSS_ATOL; one host sync a call. The
    placeholder first stage (no valid proposal) gives JAX's constant class
    loss and zero box losses."""
    b, k, c, g, s = 2, 20, 6, 5, 60
    outputs = {**_heads(rng, b, k, c), "aux_outputs": [_heads(rng, b, k, c) for _ in range(2)],
               "init_reference": _heads(rng, b, k, c)["pred_boxes"]}
    if enc == "placeholder":
        outputs["enc_outputs"] = {"pred_logits": np.zeros((b, s, 1), np.float32),
                                  "pred_boxes": np.full((b, s, 4), 0.5, np.float32),
                                  "anchors": np.full((b, s, 4), 0.5, np.float32),
                                  "valid": np.zeros((b, s), bool)}
    else:
        h = _heads(rng, b, s, 1)
        outputs["enc_outputs"] = {"pred_logits": h["pred_logits"], "pred_boxes": h["pred_boxes"],
                                  "anchors": _heads(rng, b, s, 1)["pred_boxes"],
                                  "valid": rng.rand(b, s) > 0.2}
    gt = _heads(rng, b, g, 1)["pred_boxes"]
    targets = _targets(gt, np.array([[1, 1, 1, 0, 0], [1, 0, 1, 1, 1]], bool),
                       rng.randint(0, c, (b, g)))
    kw = dict(num_classes=c, num_queries=k, use_stage2=False, losses=("class", "boxes"),
              weight_dict=DETR_WEIGHTS)

    def tree(fn, x):
        return {kk: tree(fn, v) if isinstance(v, dict) else ([tree(fn, a) for a in v]
                if isinstance(v, list) else fn(v)) for kk, v in x.items()}

    want = j_criterion.DeformableCriterion(**kw)(jax.random.PRNGKey(0), tree(jnp.asarray, outputs),
                                                 _jax_targets(targets), jnp.asarray(4.0))
    before = matchers.SYNCS["hungarian"]
    got = DeformableCriterion(**kw)(tree(_t, outputs), _port_targets(targets), torch.tensor(4.0))
    assert matchers.SYNCS["hungarian"] == before + 1
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        np.testing.assert_allclose(float(v), float(want[name]), atol=LOSS_ATOL, rtol=1e-5,
                                   err_msg=name)
    if enc == "placeholder":
        assert float(got["loss_bbox_enc"]) == 0.0 and float(got["loss_class_enc"]) > 0.0
    assert DeformableCriterion(**kw).total(got) > 0


def _r50_batch(tree: str):
    """A padded 56 x 60 image in the 64^2 canvas, its text, two valid gt
    boxes of three slots, and GT masks at the mask features' 16^2."""
    img, sizes, text, valid = tiny_inputs(R50_DIMS, h=224, w=240)
    tg = _targets([[[0.35, 0.4, 0.3, 0.35], [0.6, 0.55, 0.25, 0.4], [0.5, 0.5, 0.1, 0.1]]],
                  [[True, True, False]], [[0, 3, 0]])
    if R50_TREES[tree][1].get("mask_on"):
        tg["masks"] = np.random.RandomState(11).rand(1, 3, 64, 64) > 0.7
    return {"images": img, "image_sizes": sizes, "text_features": text, "text_valid": valid,
            "targets": tg}


def _num_classes(tree: str) -> int:
    return R50_TREES[tree][1].get("num_learned_classes") or R50_DIMS["num_text"] + 1


def _jax_step(pair, tree: str):
    """JAX's make_train_step on the tree's batch: metrics and gradients."""
    jm, params, _, _ = pair
    crit = j_criterion.DeformableCriterion(**_criterion_kw(tree, _num_classes(tree)))
    batch = _r50_batch(tree)
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items() if k != "targets"},
              "targets": _jax_targets(batch["targets"])}
    step = j_train_step.make_train_step(jm, crit, _recording_tx())
    state, metrics = jax.jit(step)(j_train_step.create_train_state(params, _recording_tx()),
                                   jbatch, jax.random.PRNGKey(0))
    grads = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(state.opt_state).items()})
    return batch, {k: float(v) for k, v in metrics.items()}, grads


STEP_TREES = ("ape", "ape_vlf", "deta")
# The ResNet's floor: 49 ReLUs, so an f32 reordering flips the gate of a
# pre-activation next to 0 and moves the gradient of a weight that reads it
# by that one position's term (res5 reads 8 x 8 positions at 256^2). The
# port against itself with the images scaled by 1 + PERTURB * N(0, 1) (f32
# rounding size) shows the same gaps as against JAX (res5.1.conv3: 2.8e-2
# of its largest entry both ways), so each gradient is held to the Ti step's
# bound or twice that floor, whichever is larger.
PERTURB = 1e-7


def _port_grads(pm, crit, batch, perturb=False):
    """(total, losses, outputs, {name: gradient or None}) of the port's
    loss_fn and backward on a copy of pm."""
    pm = copy.deepcopy(pm).train()
    b = _port_batch(batch)
    if perturb:
        noise = torch.randn(b["images"].shape, generator=torch.Generator().manual_seed(1))
        b["images"] = b["images"] * (1 + PERTURB * noise)
    total, losses, outputs = loss_fn(pm, crit, b, torch.Generator().manual_seed(0))
    total.backward()
    return total, losses, outputs, {n: p.grad for n, p in pm.named_parameters()}


def _grad_mismatches_over_floor(grads, want, floor):
    """Names whose gradient is off JAX's by more than GRAD_RTOL of its
    largest entry (1e-5 absolute where that is tiny) and more than twice
    the floor's gap."""
    bad = {}
    for name, g in grads.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        f = 0.0 if floor[name] is None else float(np.abs(floor[name].numpy() - g).max())
        err = float(np.abs(g - w).max())
        if err > max(GRAD_RTOL * float(np.abs(w).max()), 1e-5, 2 * f):
            bad[name] = (err, f)
    return bad


@pytest.mark.parametrize("tree", STEP_TREES)
def test_r50_train_step_matches_jax(tree):
    """The port's loss_fn and backward against JAX's step: every loss term,
    the total and every parameter's gradient within the Ti step's bounds or
    twice the ResNet's floor (PERTURB), the fusion tree under recompute;
    the stem without a gradient, as JAX's zero; the FrozenBN constants are
    not parameters, and JAX's gradients there are zero."""
    pair = model_pair(jax_tiny_r50(tree), torch_tiny_r50(tree))
    batch, metrics, want = _jax_step(pair, tree)
    pm = pair[3]
    if tree == "ape_vlf":
        pm = copy.deepcopy(pm)
        pm.transformer.encoder.use_act_checkpoint = True
        pm.transformer.decoder.use_act_checkpoint = True
    crit = DeformableCriterion(**_criterion_kw(tree, _num_classes(tree)))
    total, losses, outputs, grads = _port_grads(pm, crit, batch)
    floor = _port_grads(pm, crit, batch, perturb=True)[3]
    if crit.use_stage2:
        tg = _port_targets(batch["targets"])
        refs = outputs["init_reference"].detach()
        assert int(_positives(tg["boxes"], tg["valid"], refs, (0.6,), (0, 1)).max()) <= STAGE2_CAP
    assert sorted(losses) == sorted(k for k in metrics if k != "total_loss")
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), metrics[k], atol=LOSS_ATOL, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total.item(), metrics["total_loss"], rtol=1e-4)
    bad = _grad_mismatches_over_floor(grads, want, floor)
    assert not bad, bad
    unused = {n for n, g in grads.items() if g is None}
    # and under name prompts the last fusion layer's language side, whose
    # fused text no head reads
    fused_text = {f"transformer.encoder.vl_layers.{R50_DIMS['layers'] - 1}.b_attn.{n}" for n in (
        "attn.values_v_proj.weight", "attn.values_v_proj.bias", "attn.out_l_proj.weight",
        "attn.out_l_proj.bias", "gamma_l")} if tree == "ape_vlf" else set()
    assert unused == {"backbone.stem.conv1.weight"} | fused_text
    assert not any(want[n].any() for n in unused)
    assert not want["backbone.stem.conv1.weight"].any()
    assert not any(want[n].any() for n, _ in pm.named_buffers())
