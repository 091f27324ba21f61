"""The port's training path against ape_tpu on the CPU, in f32: the
assigners, the criterion, the optimizer, and one whole train step (total loss
and every parameter's gradient), plus the detach faults these tests catch, an
overfit run, and the train step's own contract (accumulation, EMA, NaN guard).

The slice runs at the parity-harness dims (img 256, 2 + 2 layers, 60 queries)
with the protocol pyramid. Random subsampling draws different numbers in the
two frameworks, so every case keeps its positives under the subsample caps
(stage2: 25% of the queries, stage1: 128 anchors) and asserts it: the
subsample is then the identity on both sides.
"""

import copy
import inspect
import re
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.parity_harness import DIMS
from tests.torch_parity import (
    flatten,
    jax_tiny_masked,
    jax_tiny_protocol,
    model_pair,
    tiny_inputs,
    torch_tiny_masked,
    torch_tiny_protocol,
)

from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu.modeling.ape_deta import matchers as j_matchers
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.engine.optimizer import build_optimizer, lr_lambda, vit_layer_id
from ape_tpu_torch.engine.train_step import loss_fn, make_train_step
from ape_tpu_torch.modeling.ape_deta import transformer as port_transformer
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from ape_tpu_torch.modeling.ape_deta.matchers import stage1_assign, stage2_assign, threshold_match
from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy, box_iou

QUERIES = DIMS["queries"]
NUM_TEXT = DIMS["num_text"] + 1  # tiny_inputs pads one invalid text slot
STAGE2_CAP = int(QUERIES * 0.25)
STAGE1_CAP = 128
# Whole-step gradients: the port and XLA sum in other orders through ~30
# layers, so each parameter's gradient is held to 2e-3 of its own largest
# entry (and 1e-5 absolute where that entry is tiny).
GRAD_RTOL = 2e-3
LOSS_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _targets(boxes, valid, labels):
    return {"labels": np.asarray(labels, np.int32), "boxes": np.asarray(boxes, np.float32),
            "valid": np.asarray(valid, bool)}


def _port_targets(t):
    return {**{k: _t(v) for k, v in t.items()}, "labels": _t(t["labels"]).long()}


def _jax_targets(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _positives(gt_boxes, gt_valid, boxes, thresholds, labels, box_valid=None):
    """Count of positives per image before the subsample (the assigner's label 1)."""
    iou, _ = box_iou(box_cxcywh_to_xyxy(gt_boxes), box_cxcywh_to_xyxy(boxes))
    ok = gt_valid[..., None] if box_valid is None else gt_valid[..., None] & box_valid[:, None]
    iou = torch.where(ok, iou, torch.full_like(iou, -1.0))
    _, label = threshold_match(iou, gt_valid, thresholds, labels)
    if box_valid is not None:
        label = torch.where(box_valid, label, torch.zeros_like(label))
    return (label == 1).sum(1)


def _random_case(rng, b=2, g=5, k=QUERIES):
    """Proposal boxes with a few near copies of each valid gt, so the IoU
    threshold and the low-quality rule both bite."""
    gt = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.3, (b, g, 2))], -1)
    valid = np.arange(g)[None].repeat(b, 0) < np.array([[3], [2]])[:b]
    refs = np.concatenate([rng.uniform(0.05, 0.95, (b, k, 2)), rng.uniform(0.02, 0.4, (b, k, 2))], -1)
    for i in range(b):
        for j in range(3):
            refs[i, 2 * j] = gt[i, j] + rng.normal(0, 0.01, 4)
    return gt.astype(np.float32), valid, refs.astype(np.float32)


def test_stage2_assign_matches(rng):
    gt, valid, refs = _random_case(rng)
    want = jax.vmap(lambda r, gb, gv, ref: j_matchers.stage2_assign(r, gb, gv, ref, QUERIES))(
        jax.random.split(jax.random.PRNGKey(0), 2), jnp.asarray(gt), jnp.asarray(valid),
        jnp.asarray(refs))
    got = stage2_assign(_t(gt), _t(valid), _t(refs), QUERIES)
    assert int(_positives(_t(gt), _t(valid), _t(refs), (0.6,), (0, 1)).max()) <= STAGE2_CAP
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() >= 3  # both thresholds and low-quality matches assign


def test_stage1_assign_matches(rng):
    gt, valid, anchors = _random_case(rng, k=700)
    anchor_valid = rng.rand(2, 700) > 0.1
    want = jax.vmap(j_matchers.stage1_assign)(
        jax.random.split(jax.random.PRNGKey(1), 2), jnp.asarray(gt), jnp.asarray(valid),
        jnp.asarray(anchors), jnp.asarray(anchor_valid))
    got = stage1_assign(_t(gt), _t(valid), _t(anchors), _t(anchor_valid))
    pos = _positives(_t(gt), _t(valid), _t(anchors), (0.3, 0.7), (0, -1, 1), _t(anchor_valid))
    assert int(pos.max()) <= STAGE1_CAP
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() >= 3


def test_subsample_caps_positives():
    """Above the cap the subsample keeps exactly the cap, a different draw per seed."""
    from ape_tpu_torch.modeling.ape_deta.matchers import subsample_positives

    pos = torch.zeros(2, 50, dtype=torch.bool)
    pos[0, :30] = True
    pos[1, 10:14] = True
    keep = [subsample_positives(pos, 8, torch.Generator().manual_seed(s)) for s in (0, 1)]
    for k in keep:
        assert k.sum(1).tolist() == [8, 4] and not (k & ~pos).any()
    assert not torch.equal(keep[0], keep[1])


def _random_outputs(rng, b=2, s=400):
    """A model-shaped output dict with references, boxes and anchors near the gts."""
    gt, valid, refs = _random_case(rng, b=b)
    _, _, anchors = _random_case(rng, b=b, k=s)
    logits = lambda *shape: rng.randn(*shape).astype(np.float32) * 2  # noqa: E731
    jitter = lambda x: np.clip(x + rng.normal(0, 0.02, x.shape), 0.01, 0.99).astype(np.float32)  # noqa: E731
    out = {
        "pred_logits": logits(b, QUERIES, NUM_TEXT), "pred_boxes": jitter(refs),
        "aux_outputs": [{"pred_logits": logits(b, QUERIES, NUM_TEXT), "pred_boxes": jitter(refs)}],
        "init_reference": refs,
        "enc_outputs": {"pred_logits": logits(b, s, 1), "pred_boxes": jitter(anchors),
                        "anchors": anchors, "valid": rng.rand(b, s) > 0.1},
    }
    labels = rng.randint(0, NUM_TEXT - 1, valid.shape)
    return out, _targets(gt, valid, labels)


def _tree(out, fn):
    if isinstance(out, dict):
        return {k: _tree(v, fn) for k, v in out.items()}
    if isinstance(out, list):
        return [_tree(v, fn) for v in out]
    return fn(out)


def test_criterion_matches(rng):
    out, tg = _random_outputs(rng)
    class_valid = np.arange(NUM_TEXT)[None].repeat(2, 0) < NUM_TEXT - 1
    jcrit = j_criterion.DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                                            weight_dict=j_criterion.default_weight_dict(),
                                            losses=("class", "boxes"))
    nb = float(tg["valid"].sum())
    want = jcrit(jax.random.PRNGKey(0), _tree(out, jnp.asarray), _jax_targets(tg),
                 jnp.asarray(nb), jnp.asarray(class_valid))
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                               weight_dict=default_weight_dict())
    got = crit(_tree(out, _t), _port_targets(tg), torch.tensor(nb), _t(class_valid))
    assert list(got) == list(want)
    assert "loss_class_enc" in got and "loss_giou_0" in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(crit.total(got)), float(jcrit.total(want)), rtol=1e-5)


def test_criterion_refuses_unported_losses():
    """Every loss of JAX's is ported (tests/test_torch_criterion_iou.py); a
    loss name neither has still raises, naming the criterion's losses."""
    DeformableCriterion(num_classes=3, weight_dict={}, losses=("class", "masks_maskdino"),
                        mask_point_sample=True)
    with pytest.raises(ValueError, match="unknown losses.*'boxes_iou'"):
        DeformableCriterion(num_classes=3, weight_dict={}, losses=("class", "boxes_iou"))


@pytest.mark.parametrize("name,layer", [
    ("backbone.net.pos_embed", 0),
    ("backbone.net.patch_embed.proj.weight", 0),
    ("backbone.net.blocks.0.attn.qkv.weight", 1),
    ("backbone.net.blocks.11.mlp.w3.bias", 12),
    ("backbone.simfp_4.0.weight", 13),
    ("transformer.encoder.layers.0.attentions.0.sampling_offsets.weight", 13),
    ("lateral_conv.weight", 13),
    ("output_conv.norm.weight", 13),
    ("mask_conv.weight", 13),
    ("mask_embed.layers.2.bias", 13),
    ("mask_embed.3.layers.0.weight", 13),
])
def test_vit_layer_id(name, layer):
    from ape_tpu.engine.optimizer import vit_layer_id as j_layer_id

    jax_path = name.replace(".net.blocks.", ".net.blocks_").replace(".", "/")
    assert vit_layer_id(name, 12) == layer == j_layer_id(jax_path, 12)


def test_lr_lambda_matches_schedule():
    from ape_tpu.engine.optimizer import make_lr_schedule

    sched = make_lr_schedule(2e-4, milestones=(3, 5), warmup_steps=4)
    factor = lr_lambda(milestones=(3, 5), warmup_steps=4)
    for step in range(12):
        # optax evaluates the schedule in f32
        np.testing.assert_allclose(2e-4 * factor(step), float(sched(step)), rtol=2e-5)


@pytest.fixture(scope="module")
def tiny_pair():
    """ape_tpu and port models at tiny protocol dims with the same weights."""
    return model_pair(jax_tiny_protocol(), torch_tiny_protocol())


@pytest.fixture(scope="module")
def masked_pair():
    """The masked models (default 4-scale pyramid, mask head) at tiny dims,
    with the encoder's sampling_offsets kernels at 0 (the reference's init).
    With random kernels the 4-scale encoder's ~440k samples a layer sit at
    random sub-pixel positions, and the two frameworks' f32 rounding moves a
    few of them across an integer pixel, where d_loc is one-sided: that alone
    moved an encoder sampling_offsets gradient by 1.8e-2 and backbone ones by
    3.6e-3 (the port against itself on images perturbed by 1e-7). With zero
    kernels the encoder's samples sit where the biases put them, whatever the
    activations, and the step agrees to ~3e-5."""
    return model_pair(jax_tiny_masked(), torch_tiny_masked(), zero_encoder_offsets=True)


def _optimizer_matches_optax(pair):
    from ape_tpu.engine.optimizer import build_optimizer as j_build_optimizer
    from tests.torch_parity import unflatten

    import optax

    jm, params, flat, pm = pair
    pm = copy.deepcopy(pm)
    kw = dict(vit_num_layers=DIMS["vit_depth"], warmup_steps=1, milestones=(1,))
    tx = j_build_optimizer(params, **kw)
    opt, sched = build_optimizer(pm, **kw)
    state = tx.init(params)
    update = jax.jit(lambda g, st, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, st, p)))
    named = dict(pm.named_parameters())
    init = state_dict_from_jax(flat)
    rng = np.random.RandomState(7)
    for _ in range(3):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flat.items()}
        params, state = update(unflatten(grads), state, params)
        for k, g in state_dict_from_jax(grads).items():
            named[k].grad = g.clone()
        torch.nn.utils.clip_grad_norm_(list(named.values()), 0.1)
        opt.step()
        sched.step()
    want = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(params).items()})
    got = pm.state_dict()
    assert sorted(want) == sorted(got)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
        moved += int(not torch.equal(got[k], init[k]))
    assert moved == len(want)


def test_optimizer_matches_optax(tiny_pair):
    """Three AdamW steps with warmup and a milestone from identical gradients,
    against optax's chain; parameters within 1e-6."""
    _optimizer_matches_optax(tiny_pair)


def test_optimizer_matches_optax_masked(masked_pair):
    """The same with the mask head: its parameters land in JAX's layer-decay
    and weight-decay groups."""
    _optimizer_matches_optax(masked_pair)


def _slice_batch(h=200, w=240):
    """One padded image, its text features, and two gt boxes (labels 0 and 3)."""
    img, sizes, text, valid = tiny_inputs(h=h, w=w)
    tg = _targets([[[0.35, 0.4, 0.3, 0.35], [0.6, 0.55, 0.25, 0.4], [0.5, 0.5, 0.1, 0.1]]],
                  [[True, True, False]], [[0, 3, 0]])
    return {"images": img, "image_sizes": sizes, "text_features": text, "text_valid": valid,
            "targets": tg}


def _masked_batch():
    """The slice batch with GT masks at the mask resolution (img / 4), drawn
    as rand > 0.7 as tools/bench_train.py draws them."""
    batch = _slice_batch()
    side = DIMS["img"] // 4
    batch["targets"]["masks"] = np.random.RandomState(11).rand(1, 3, side, side) > 0.7
    return batch


def _port_batch(batch):
    out = {k: _t(v) for k, v in batch.items() if k != "targets"}
    out["targets"] = _port_targets(batch["targets"])
    return out


def _jax_step(pair, batch, losses):
    """JAX's loss and gradient of one step: model.apply, then the criterion
    (train_step.py loss_fn), with the first-stage indices it selected."""
    import ape_tpu.modeling.ape_deta.transformer as jt

    jm, params, _, _ = pair
    crit = j_criterion.DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                                           weight_dict=j_criterion.default_weight_dict(),
                                           losses=losses)
    targets = _jax_targets(batch["targets"])
    selected = []
    select = jt.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    def jax_loss(p):
        out = jm.apply({"params": p}, *(jnp.asarray(batch[k]) for k in
                                        ("images", "image_sizes", "text_features", "text_valid")),
                       deterministic=False, align_on_fused=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        nb = jnp.clip(jnp.sum(targets["valid"].astype(jnp.float32)), 1.0)
        losses = crit(jax.random.PRNGKey(0), out, targets, nb, None)
        return crit.total(losses), (losses, out["init_reference"], out["enc_outputs"])

    jt.deta_first_stage_select = recording_select
    try:
        (total, (losses, refs, enc)), grads = jax.jit(
            jax.value_and_grad(jax_loss, has_aux=True))(params)
    finally:
        jt.deta_first_stage_select = select
    grads = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(grads).items()})
    return dict(batch=batch, total=float(total), losses={k: float(v) for k, v in losses.items()},
                grads=grads, selected=selected[-1], refs=np.asarray(refs),
                anchors=np.asarray(enc["anchors"]), anchor_valid=np.asarray(enc["valid"]))


@pytest.fixture(scope="module")
def jax_step(tiny_pair):
    """JAX's detection step on the protocol model."""
    return _jax_step(tiny_pair, _slice_batch(), ("class", "boxes"))


@pytest.fixture(scope="module")
def masked_jax_step(masked_pair):
    """JAX's masked step, losses ("class", "boxes", "masks"), as the JAX
    train benchmark runs it."""
    return _jax_step(masked_pair, _masked_batch(), ("class", "boxes", "masks"))


def _port_step(pm, batch, use_act_checkpoint=False):
    pm = copy.deepcopy(pm).train()
    pm.transformer.encoder.use_act_checkpoint = use_act_checkpoint
    pm.transformer.decoder.use_act_checkpoint = use_act_checkpoint
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                               weight_dict=default_weight_dict())
    pm.zero_grad()
    total, losses, outputs = loss_fn(pm, crit, _port_batch(batch))
    total.backward()
    return pm, total, losses, outputs


def _grad_mismatches(pm, want_grads):
    """Names whose gradient is off by more than GRAD_RTOL of its largest entry."""
    bad = {}
    for name, p in pm.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = float(np.abs(g - w).max())
        if err > max(GRAD_RTOL * float(np.abs(w).max()), 1e-5):
            bad[name] = err
    return bad


def _check_step(pm, jax_step, use_act_checkpoint):
    """The port's step against JAX's: identical first-stage indices, every
    loss term, the total and every parameter's gradient."""
    batch = jax_step["batch"]
    pm, total, losses, outputs = _port_step(pm, batch, use_act_checkpoint)
    np.testing.assert_array_equal(outputs["first_stage_indices"].numpy(), jax_step["selected"])
    tg = _port_targets(batch["targets"])
    refs = outputs["init_reference"].detach()
    assert int(_positives(tg["boxes"], tg["valid"], refs, (0.6,), (0, 1)).max()) <= STAGE2_CAP
    enc = outputs["enc_outputs"]
    assert int(_positives(tg["boxes"], tg["valid"], enc["anchors"], (0.3, 0.7), (0, -1, 1),
                          enc["valid"]).max()) <= STAGE1_CAP
    assert sorted(losses) == sorted(jax_step["losses"])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), jax_step["losses"][k], atol=LOSS_ATOL, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(total.item(), jax_step["total"], rtol=1e-4)
    assert not _grad_mismatches(pm, jax_step["grads"])
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in pm.parameters())
    return losses


@pytest.mark.parametrize("use_act_checkpoint", [False, True])
def test_train_step_loss_and_grads_match(tiny_pair, jax_step, use_act_checkpoint):
    """Total loss, every loss term, and every parameter's gradient of one
    step, with identical first-stage indices; with and without recompute."""
    _check_step(tiny_pair[3], jax_step, use_act_checkpoint)


@pytest.mark.parametrize("use_act_checkpoint", [False, True])
def test_masked_train_step_loss_and_grads_match(masked_pair, masked_jax_step, use_act_checkpoint):
    """The same for the masked model with the mask losses: every parameter's
    gradient, the mask head's included."""
    losses = _check_step(masked_pair[3], masked_jax_step, use_act_checkpoint)
    assert losses["loss_mask"].item() > 0 and losses["loss_dice"].item() > 0


def _without_detach(cls, target):
    """cls.forward with ``.detach()`` taken off the one statement that assigns
    ``target``: the fault planted by name, compiled in the module's globals."""
    src = textwrap.dedent(inspect.getsource(cls.forward))
    pattern = re.compile(rf"^(\s*{target} = .*)\.detach\(\)$", re.M)
    src, n = pattern.subn(r"\1", src)
    assert n == 1, f"no single `{target} = ....detach()` in {cls.__name__}.forward"
    scope = {}
    exec(compile(src, inspect.getsourcefile(cls), "exec"), vars(port_transformer), scope)
    return scope["forward"]


@pytest.mark.parametrize("fault,cls,target,caught", [
    (1, port_transformer.DeformableDetrTransformer, "topk_coords_unact",
     f"transformer.decoder.bbox_embed.{DIMS['layers']}.layers.0.weight"),
    (2, port_transformer.DeformableDetrTransformer, "topk_feats", "transformer.enc_output.weight"),
    (3, port_transformer.DeformableTransformerDecoder, "refs", "transformer.pix_trans.weight"),
])
def test_detach_faults_are_caught(tiny_pair, jax_step, monkeypatch, fault, cls, target, caught):
    """Each of the three missing detaches makes the gradient test fail: the
    selected boxes at the encoder's bbox head (and enc_output), the selected
    features at enc_output, the references between decoder layers at
    pix_trans (and the decoder's bbox heads), among others."""
    _, _, _, pm = tiny_pair
    monkeypatch.setattr(cls, "forward", _without_detach(cls, target))
    pm, _, _, _ = _port_step(pm, jax_step["batch"])
    bad = _grad_mismatches(pm, jax_step["grads"])
    assert caught in bad, sorted(bad)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_grad_floor_under_rounding_perturbation(seed):
    """chip_smoke's f32 train check, its floor measurement at tiny dims: the
    plain step repeated gives identical gradients, and with the images
    perturbed at f32 rounding size every gradient moves by less than the
    bound the check holds the CUDA kernels to."""
    import chip_smoke

    pm = chip_smoke.init_weights(torch_tiny_protocol(), seed, fan_in=True).train()
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                               weight_dict=default_weight_dict())
    batch = _port_batch(_slice_batch())
    moved = chip_smoke.perturbed(batch, seed + 1)
    assert not torch.equal(moved["images"], batch["images"])
    _, sel, grads = chip_smoke.step_grads(pm, crit, batch, 0)
    _, again_sel, again = chip_smoke.step_grads(pm, crit, batch, 0)
    _, moved_sel, floor = chip_smoke.step_grads(pm, crit, moved, 0)
    assert torch.equal(again_sel, sel) and torch.equal(moved_sel, sel)
    assert max(chip_smoke.grad_rel_errors(again, grads).values()) == 0.0
    over = {n: r for n, r in chip_smoke.grad_rel_errors(floor, grads).items()
            if not r < chip_smoke.f32_grad_bound(n)}
    assert not over, over


def test_overfit_one_image():
    """At tiny dims, one image with two gt boxes: 40 steps of the port's train
    step cut the total loss by at least 3x. (No wall-clock limit: on a
    shared CPU it would time the neighbours.)"""
    torch.manual_seed(0)
    pm = torch_tiny_protocol()
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                               weight_dict=default_weight_dict())
    opt, sched = build_optimizer(pm, base_lr=1e-3, vit_num_layers=DIMS["vit_depth"])
    step = make_train_step(pm, crit, opt, sched)
    batch = _port_batch(_slice_batch(256, 256))
    gen = torch.Generator().manual_seed(0)
    totals = [float(step(batch, gen)["total_loss"]) for _ in range(40)]
    assert min(totals[-5:]) < totals[0] / 3, totals


def test_iter_size_accumulates_mean_grads(tiny_pair):
    """iter_size=2 over a batch of two equal images: the same update as one
    micro-batch of one image."""
    _, _, _, pm = tiny_pair
    one = _port_batch(_slice_batch())
    two = {k: (torch.cat([v, v]) if k != "targets" else {kk: torch.cat([vv, vv]) for kk, vv in v.items()})
           for k, v in one.items()}
    results = []
    for batch, iter_size in ((one, 1), (two, 2)):
        m = copy.deepcopy(pm)
        crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                                   weight_dict=default_weight_dict())
        opt, _ = build_optimizer(m, vit_num_layers=DIMS["vit_depth"])
        metrics = make_train_step(m, crit, opt, iter_size=iter_size)(batch)
        results.append((float(metrics["total_loss"]), float(metrics["grad_norm"]),
                        m.state_dict()))
    (l1, n1, s1), (l2, n2, s2) = results
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    np.testing.assert_allclose(n2, n1, rtol=1e-4)
    for k in s1:
        np.testing.assert_allclose(s2[k].numpy(), s1[k].numpy(), atol=1e-6, err_msg=k)


def test_ema_and_nan_guard(tiny_pair):
    """EMA moves by (1 - decay) of the step; a non-finite loss raises before
    the update."""
    _, _, _, pm = tiny_pair
    m = copy.deepcopy(pm)
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=QUERIES,
                               weight_dict=default_weight_dict())
    opt, _ = build_optimizer(m, vit_num_layers=DIMS["vit_depth"])
    step = make_train_step(m, crit, opt, ema_decay=0.9)
    before = [p.detach().clone() for p in m.parameters()]
    step(_port_batch(_slice_batch()))
    for e, b, p in zip(step.ema, before, m.parameters()):
        torch.testing.assert_close(e, 0.9 * b + 0.1 * p.detach(), rtol=1e-6, atol=1e-7)
    bad = _port_batch(_slice_batch())
    bad["images"][0, 0, 0, 0] = float("nan")
    after = [p.detach().clone() for p in m.parameters()]
    with pytest.raises(FloatingPointError):
        step(bad)
    assert all(torch.equal(a, p) for a, p in zip(after, m.parameters()))
