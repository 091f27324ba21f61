"""A tiny ViTDet-L APE-DETA (the inline tree of
``configs/COCO_InstanceSegmentation/ape_deta/ape_deta_vitl_lsj1024_cp_12ep.py``
at the parity harness's widths: no RoPE, relative positions, GELU MLP, a
padded window and a global block; masked on the 4-scale pyramid) against
ape_tpu's on the CPU in f32: logits and boxes within 1e-4, mask logits within
1e-4 of their largest entry, first-stage indices identical; one f32 train
step against ``jax.value_and_grad``: every loss term, and every parameter's
gradient within 2e-3 of its own largest entry, the relative-position
tables' included. The weights are the harness's draw: its N(0, 0.05) puts
the relative-position tables away from JAX's zero init.

The same step holds the two EVA-01 ViT-g recipes' tiny trees (head width
88, three padded windows and a global block): the DETA recipe's (relative
positions, LVIS's 1203 learned classes, the federated loss over 50 with
LVIS's weights on JAX's uniforms) and EVA-01-CLIP-g's (absolute positions
only, the GELU MLP at 6144/1408, drop path 0.6 on the port's keep masks,
which JAX's DropPath is handed).
"""

import copy
import functools

import flax.linen as nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.data.datasets import metadata as j_metadata
from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu.modeling.backbone import eva_vit as j_vit
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.data.datasets.metadata import fed_loss_cls_weights
from ape_tpu_torch.engine.train_step import loss_fn
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from ape_tpu_torch.modeling.backbone.eva_vit import draw_keep
from tests.parity_harness import DIMS
from tests.torch_parity import (
    VITG_LEARNED_CLASSES,
    flatten,
    jax_tiny_vitdet,
    jax_tiny_vitg,
    model_pair,
    tiny_inputs,
    torch_tiny_vitdet,
    torch_tiny_vitg,
)

ATOL = 1e-4
GRAD_RTOL = 2e-3


def _t(x):
    return torch.from_numpy(np.array(x))


_PAIR = []


def _pair():
    if not _PAIR:
        jm, params, flat, pm = model_pair(jax_tiny_vitdet(), torch_tiny_vitdet())
        assert all(np.abs(flat[k]).min() > 0 for k in flat if "rel_pos" in k)
        _PAIR.append((jm, params, flat, pm))
    return _PAIR[0]


def test_tiny_vitdet_ape_deta_matches_ape_tpu(monkeypatch):
    """The tiny ViTDet-L APE-DETA on a padded image: logits, boxes, mask
    logits and first-stage indices against JAX's."""
    import ape_tpu.modeling.ape_deta.transformer as jt

    jm, params, flat, pm = _pair()
    assert sum("rel_pos" in k for k in flat) == 6 and any("mlp/fc1" in k for k in flat)
    assert [b.attn.flash for b in pm.backbone.net.blocks] == [False] * 3
    selected = []
    select = jt.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    monkeypatch.setattr(jt, "deta_first_stage_select", recording_select)
    inputs = tiny_inputs(h=200, w=240)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        got = pm.eval()(*(_t(a) for a in inputs))
    np.testing.assert_array_equal(got["first_stage_indices"].numpy(), selected[-1])
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)
    masks = np.asarray(want["pred_masks"])
    assert np.abs(got["pred_masks"].numpy() - masks).max() <= ATOL * np.abs(masks).max()


# The step cases: (JAX model, port model, the 0-based targets' labels, the
# criterion's classes, its losses, whether the criterion's loss is federated).
# ViTDet-L: masked, open vocabulary (the tiny text, the last slot invalid).
# The DETA ViT-g: no masks, LVIS's 1203 learned classes, the federated loss
# over 50 of them with LVIS's weights (JAX's uniforms handed to the port).
# EVA-01-CLIP-g: masked, open vocabulary, drop path 0.6 (the port's keep
# masks, from the step's generator, handed to JAX's DropPath).
STEP_CASES = {
    "vitdet": (jax_tiny_vitdet, torch_tiny_vitdet, [0, 3, 0], DIMS["num_text"] + 1,
               ("class", "boxes", "masks"), False),
    "vitg_deta": (functools.partial(jax_tiny_vitg, True), functools.partial(torch_tiny_vitg, True),
                  [17, 1102, 0], VITG_LEARNED_CLASSES, ("class", "boxes"), True),
    "vitg_eva01_clip": (functools.partial(jax_tiny_vitg, False),
                        functools.partial(torch_tiny_vitg, False), [0, 3, 0],
                        DIMS["num_text"] + 1, ("class", "boxes", "masks"), False),
}
FED_CLASSES = 50
_PAIRS = {}


def _case_pair(case):
    if case == "vitdet":
        return _pair()
    if case not in _PAIRS:
        jax_model, torch_model = STEP_CASES[case][:2]
        jm, params, flat, pm = model_pair(jax_model(), torch_model())
        assert all(np.abs(flat[k]).min() > 0 for k in flat if "rel_pos" in k)
        _PAIRS[case] = (jm, params, flat, pm)
    return _PAIRS[case]


def _kept_drop_path(keep):
    """JAX's DropPath applying ``keep`` ((depth, 2, B) bool, the port's
    draw) where JAX's would draw its own: block i's branch j (``drop_path{j +
    1}``) keeps sample b by keep[i, j, b]."""

    class KeptDropPath(j_vit.DropPath):
        @nn.compact
        def __call__(self, x, deterministic: bool = True):
            if deterministic or self.rate == 0.0:
                return x
            block, branch = self.scope.path[-2:]
            mask = keep[int(block.split("_")[1]), int(branch[-1]) - 1]
            mask = jnp.asarray(mask).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
            return jnp.where(mask, x / (1.0 - self.rate), 0.0)

    return KeptDropPath


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tiny_vitdet_train_step_matches_ape_tpu(case, monkeypatch):
    """One step of each STEP_CASES tree (name prompts): the loss terms and
    every parameter's gradient, the relative-position tables' among them,
    against JAX's ``jax.value_and_grad``."""
    jm, params, _, pm = _case_pair(case)
    _, _, labels, num_classes, losses_kw, fed = STEP_CASES[case]
    img, sizes, text, valid = tiny_inputs(h=200, w=240)
    side = DIMS["img"] // 4
    targets = {"labels": np.asarray([labels], np.int32),
               "boxes": np.asarray([[[0.35, 0.4, 0.3, 0.35], [0.6, 0.55, 0.25, 0.4],
                                     [0.5, 0.5, 0.1, 0.1]]], np.float32),
               "valid": np.asarray([[True, True, False]])}
    if "masks" in losses_kw:
        targets["masks"] = np.random.RandomState(11).rand(1, 3, side, side) > 0.7
    crit_kw = dict(num_classes=num_classes, num_queries=DIMS["queries"], losses=losses_kw)
    if fed:
        crit_kw.update(use_fed_loss=True, fed_loss_num_classes=FED_CLASSES)
    jcrit = j_criterion.DeformableCriterion(
        weight_dict=j_criterion.default_weight_dict(), **crit_kw,
        **({"fed_loss_cls_weights": jnp.asarray(j_metadata.fed_loss_cls_weights("lvis_v1_train"))}
           if fed else {}))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    pm = copy.deepcopy(pm).train()
    rates = pm.backbone.net.drop_path_rates
    keep = draw_keep(rates, 1, "cpu", torch.Generator().manual_seed(0)).numpy()
    if any(rates):
        monkeypatch.setattr(j_vit, "DropPath", _kept_drop_path(keep))
    key = jax.random.PRNGKey(0)

    def jax_loss(p):
        out = jm.apply({"params": p}, *(jnp.asarray(a) for a in (img, sizes, text, valid)),
                       deterministic=False, align_on_fused=False, rngs={"dropout": key})
        nb = jnp.clip(jnp.sum(jt["valid"].astype(jnp.float32)), 1.0)
        losses = jcrit(key, out, jt, nb, None)
        return jcrit.total(losses), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    want = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(grads).items()})

    crit = DeformableCriterion(
        weight_dict=default_weight_dict(), **crit_kw,
        **({"fed_loss_cls_weights": torch.tensor(fed_loss_cls_weights("lvis_v1_train"))}
           if fed else {}))
    if fed:  # JAX's draw in place of the port's: the criterion's split (match, fed, ...)
        r_fed = jax.random.split(key, 4)[1]
        uniforms = {c: _t(jax.random.uniform(r_fed, (c,), minval=1e-9, maxval=1.0))
                    for c in (num_classes, 1)}
        crit.draw_fed_uniforms = lambda widths, generator, device: {
            c: uniforms[c].to(device) for c in widths}
    batch = {"images": _t(img), "image_sizes": _t(sizes), "text_features": _t(text),
             "text_valid": _t(valid),
             "targets": {**{k: _t(v) for k, v in targets.items()},
                         "labels": _t(targets["labels"]).long()}}
    got_total, got_losses, _ = loss_fn(pm, crit, batch, torch.Generator().manual_seed(0))
    got_total.backward()
    assert sorted(got_losses) == sorted(losses)
    for k, v in got_losses.items():
        np.testing.assert_allclose(v.item(), float(losses[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    bad = {}
    for name, p in pm.named_parameters():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = float(np.abs(g - w).max())
        if err > max(GRAD_RTOL * float(np.abs(w).max()), 1e-5):
            bad[name] = err
    assert not bad
    net = pm.backbone.net
    rel = [n for n, _ in pm.named_parameters() if "rel_pos" in n]
    assert len(rel) == 2 * len(net.blocks) * net.blocks[0].attn.use_rel_pos
    assert all(float(pm.get_parameter(n).grad.abs().max()) > 0 for n in rel)
    assert [b.attn.flash for b in net.blocks] == [False] * len(net.blocks)
    if case == "vitg_deta":
        assert pm.class_embedding.grad is not None and pm.class_embedding.shape[0] == 1203
    if any(rates):  # the draw keeps some branches of the dropping blocks, drops others
        dropping = keep[[i for i, r in enumerate(rates) if r]]
        assert dropping.any() and not dropping.all()
