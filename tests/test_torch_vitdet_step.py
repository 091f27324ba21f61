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
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.engine.train_step import loss_fn
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from tests.parity_harness import DIMS
from tests.torch_parity import flatten, jax_tiny_vitdet, model_pair, tiny_inputs, torch_tiny_vitdet

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


def test_tiny_vitdet_train_step_matches_ape_tpu():
    """One masked step (name prompts): the loss terms and every parameter's
    gradient, the relative-position tables' among them, against JAX's."""
    jm, params, _, pm = _pair()
    img, sizes, text, valid = tiny_inputs(h=200, w=240)
    side = DIMS["img"] // 4
    targets = {"labels": np.asarray([[0, 3, 0]], np.int32),
               "boxes": np.asarray([[[0.35, 0.4, 0.3, 0.35], [0.6, 0.55, 0.25, 0.4],
                                     [0.5, 0.5, 0.1, 0.1]]], np.float32),
               "valid": np.asarray([[True, True, False]]),
               "masks": np.random.RandomState(11).rand(1, 3, side, side) > 0.7}
    crit_kw = dict(num_classes=DIMS["num_text"] + 1, num_queries=DIMS["queries"],
                   losses=("class", "boxes", "masks"))
    jcrit = j_criterion.DeformableCriterion(weight_dict=j_criterion.default_weight_dict(),
                                            **crit_kw)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def jax_loss(p):
        out = jm.apply({"params": p}, *(jnp.asarray(a) for a in (img, sizes, text, valid)),
                       align_on_fused=False)
        nb = jnp.clip(jnp.sum(jt["valid"].astype(jnp.float32)), 1.0)
        losses = jcrit(jax.random.PRNGKey(0), out, jt, nb, None)
        return jcrit.total(losses), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    want = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(grads).items()})

    pm = copy.deepcopy(pm).train()
    crit = DeformableCriterion(weight_dict=default_weight_dict(), **crit_kw)
    batch = {"images": _t(img), "image_sizes": _t(sizes), "text_features": _t(text),
             "text_valid": _t(valid),
             "targets": {**{k: _t(v) for k, v in targets.items()},
                         "labels": _t(targets["labels"]).long()}}
    got_total, got_losses, _ = loss_fn(pm, crit, batch)
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
    rel = [n for n, _ in pm.named_parameters() if "rel_pos" in n]
    assert len(rel) == 6 and all(float(pm.get_parameter(n).grad.abs().max()) > 0 for n in rel)
