"""The port's ``proposal_ambiguous`` first stage against ape_tpu's on the
CPU, in f32: copies of the objectness head and of the box MLP, whose
per-proposal argmax over the 1 + N objectness logits picks the logit and
the box that go on (JAX's transformer.py:638-660).

* with 1 and 2 copies, on the tiny Ti and L_D trees: the first stage's
  logits and boxes and the last layer's logits and boxes within 1e-4 of
  JAX's, the head each proposal takes and the first-stage indices
  identical (JAX's heads read from its captured head outputs);
* a copy whose bias is raised wins everywhere, and the first stage then
  equals a model whose own heads are that copy's; a forced tie (a copy
  equal to the base head) picks head 0, as ``jnp.argmax`` does;
* the state-dict round trip with the copies, and the build functions' option;
* one f32 train step: the copies' gradients within 1e-4 of their largest
  entry of ``jax.grad``'s, zero for a copy that no proposal picks; the
  criterion reads only the picked outputs (``enc_outputs``), in JAX as in
  the port.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.engine.train_step import loss_fn
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from tests.parity_harness import DIMS
from tests.torch_parity import (
    L_D_FUSION,
    L_D_VIT,
    flatten,
    jax_tiny,
    model_pair,
    tiny_inputs,
    torch_tiny,
    unflatten,
)

ATOL = 1e-4
GRAD_RTOL = 1e-4
TREES = {"ti": {}, "l_d": {"vit": L_D_VIT, "fusion": L_D_FUSION}}


def _t(x):
    return torch.from_numpy(np.array(x))


_PAIRS = {}


def _pair(tree, n):
    """ape_tpu and port tiny models of ``tree`` with ``n`` copies, the same
    seeded weights; built once a module."""
    if (tree, n) not in _PAIRS:
        _PAIRS[tree, n] = model_pair(jax_tiny(proposal_ambiguous=n, **TREES[tree]),
                                     torch_tiny(proposal_ambiguous=n, **TREES[tree]))
    return _PAIRS[tree, n]


def _is_head(mdl, method):
    """capture_intermediates' filter: the objectness heads' outputs."""
    name = mdl.name or ""
    return method == "__call__" and (name == "enc_class_head_linear"
                                     or name.startswith("class_embed_ambiguous_"))


def jax_first_stage(jm, params, inputs, **kw):
    """JAX's forward (fusion against the text), its first-stage indices, and
    the head each proposal took: the argmax over the captured objectness
    logits of the base head and the copies (B, S)."""
    import ape_tpu.modeling.ape_deta.transformer as jt

    selected = []
    select = jt.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    jt.deta_first_stage_select = recording_select
    try:
        out, state = jax.jit(lambda p, *a: jm.apply(
            {"params": p}, *a, capture_intermediates=_is_head, mutable=["intermediates"],
            **kw))(params, *(jnp.asarray(a) for a in inputs))
    finally:
        jt.deta_first_stage_select = select
    inter = state["intermediates"]
    copies = inter["transformer"]["decoder"]
    logits = [inter["enc_class_head_linear"]["__call__"][0]] + [
        copies[f"class_embed_ambiguous_{i}"]["__call__"][0] for i in range(len(copies))]
    heads = np.asarray(jnp.argmax(jnp.stack([x[..., 0] for x in logits], 1), 1))
    return out, selected[-1], heads


def port_forward(pm, inputs, **kw):
    """The port's forward in train() mode (which returns the first stage's
    outputs; the tiny trees have no drop path)."""
    pm.train()
    with torch.no_grad():
        return pm(*(_t(a) for a in inputs), **kw)


def _check_against_jax(want, sel, heads, got):
    np.testing.assert_array_equal(got["first_stage_heads"].numpy(), heads)
    np.testing.assert_array_equal(got["first_stage_indices"].numpy(), sel)
    for key, name in (("pred_logits", "enc_logits"), ("pred_boxes", "enc_coords")):
        np.testing.assert_allclose(got["enc_outputs"][key].numpy(),
                                   np.asarray(want["enc_outputs"][key]), atol=ATOL, err_msg=name)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("tree", ["ti", "l_d"])
def test_ambiguous_first_stage_matches_ape_tpu(tree, n):
    """The picked first stage, the head each proposal took, the selection and
    the last layer's outputs, on a padded image; every head wins somewhere."""
    jm, params, _, pm = _pair(tree, n)
    inputs = tiny_inputs(h=200, w=240)
    want, sel, heads = jax_first_stage(jm, params, inputs)
    got = port_forward(pm, inputs)
    assert got["first_stage_heads"].shape == (1, got["enc_outputs"]["valid"].shape[1])
    assert set(np.unique(heads)) == set(range(n + 1))
    _check_against_jax(want, sel, heads, got)


def _set_copy(flat, pm, i, bias_shift=0.0, like_base=False):
    """Copy ``i``'s objectness head in the flax params and the port: its bias
    shifted by ``bias_shift``, or its weights equal to the base head's."""
    flat = dict(flat)
    k, b = (f"transformer/decoder/class_embed_ambiguous_{i}/{x}" for x in ("kernel", "bias"))
    if like_base:
        flat[k] = flat["enc_class_head_linear/kernel"].copy()
        flat[b] = flat["enc_class_head_linear/bias"].copy()
    flat[b] = flat[b] + np.float32(bias_shift)
    pm = copy.deepcopy(pm)
    pm.load_state_dict(state_dict_from_jax(flat), strict=True)
    return flat, pm


def test_a_raised_copy_wins_everywhere():
    """Copy 1's bias raised by 100: every proposal takes head 1, as in JAX,
    and the first stage equals that of a model whose own heads are copy 1's
    (bit for bit)."""
    jm, _, flat, pm = _pair("ti", 2)
    flat, pm = _set_copy(flat, pm, 1, bias_shift=100.0)
    inputs = tiny_inputs()
    want, sel, heads = jax_first_stage(jm, unflatten(flat), inputs)
    got = port_forward(pm, inputs)
    assert (got["first_stage_heads"] == 2).all()
    _check_against_jax(want, sel, heads, got)
    swapped = dict(flat)
    for part in ("kernel", "bias"):
        swapped[f"enc_class_head_linear/{part}"] = flat[
            f"transformer/decoder/class_embed_ambiguous_1/{part}"]
        for j in range(3):
            swapped[f"transformer/decoder/bbox_embed_{DIMS['layers']}/layer{j}/{part}"] = flat[
                f"transformer/decoder/bbox_embed_ambiguous_1/layer{j}/{part}"]
    plain = torch_tiny()
    plain.load_state_dict({k: v for k, v in state_dict_from_jax(swapped).items()
                           if "ambiguous" not in k}, strict=True)
    ref = port_forward(plain, inputs)
    for key in ("pred_logits", "pred_boxes", "valid"):
        assert torch.equal(got["enc_outputs"][key], ref["enc_outputs"][key]), key
    assert torch.equal(got["first_stage_indices"], ref["first_stage_indices"])


def test_a_forced_tie_picks_head_0():
    """A copy equal to the base objectness head ties it on every proposal:
    head 0 wins (jnp.argmax's first maximum), so the boxes are the base box
    MLP's, as in JAX, and equal those of the model without copies."""
    jm, _, flat, pm = _pair("ti", 1)
    flat, pm = _set_copy(flat, pm, 0, like_base=True)
    inputs = tiny_inputs()
    want, sel, heads = jax_first_stage(jm, unflatten(flat), inputs)
    assert (heads == 0).all()
    got = port_forward(pm, inputs)
    _check_against_jax(want, sel, heads, got)
    plain = torch_tiny()
    plain.load_state_dict({k: v for k, v in state_dict_from_jax(flat).items()
                           if "ambiguous" not in k}, strict=True)
    ref = port_forward(plain, inputs)
    assert torch.equal(got["enc_outputs"]["pred_boxes"], ref["enc_outputs"]["pred_boxes"])


def test_weight_round_trip_with_the_copies():
    """JAX's APE-Ti tree with two copies survives flax -> port -> flax
    exactly, the copies under the reference's names, and build_ape_ti takes
    it strictly; every two-stage build function holds the copies."""
    from ape_tpu.checkpoint.convert import convert_torch_state_dict
    from ape_tpu.modeling.build import build_ape_ti as j_build
    from ape_tpu_torch.modeling.build import build_ape_l, build_ape_l_d, build_ape_r50, build_ape_ti

    jm = j_build(img_size=64, num_queries=12, proposal_ambiguous=2)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64, 64]]),
        jnp.zeros((1, 4, 1024)), jnp.ones((1, 4), bool)))["params"]
    rng = np.random.RandomState(0)
    flat = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flatten(shapes).items()}
    assert "transformer/decoder/class_embed_ambiguous_1/kernel" in flat
    assert "transformer/decoder/bbox_embed_ambiguous_1/layer2/bias" in flat
    sd = state_dict_from_jax(flat)
    assert "transformer.decoder.class_embed_ambiguous.1.weight" in sd
    assert "transformer.decoder.bbox_embed_ambiguous.1.layers.2.bias" in sd
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    build_ape_ti(num_queries=12, proposal_ambiguous=2, device="cpu").load_state_dict(
        sd, strict=True)
    small = dict(num_layers=1, proposal_ambiguous=1, device="cpu")
    for model in (build_ape_l_d(depth=1, **small), build_ape_l(depth=1, **small),
                  build_ape_r50(**small)):
        dec = model.transformer.decoder
        assert len(dec.class_embed_ambiguous) == len(dec.bbox_embed_ambiguous) == 1
        assert float(dec.class_embed_ambiguous[0].bias.detach()) == pytest.approx(-np.log(99.0))
    assert not hasattr(build_ape_ti(num_queries=12, device="cpu").transformer.decoder,
                       "class_embed_ambiguous")


QUERIES = DIMS["queries"]
NUM_TEXT = DIMS["num_text"] + 1


def _batch():
    img, sizes, text, valid = tiny_inputs(h=200, w=240)
    targets = {"labels": np.asarray([[0, 3, 0]], np.int32),
               "boxes": np.asarray([[[0.35, 0.4, 0.3, 0.35], [0.6, 0.55, 0.25, 0.4],
                                     [0.5, 0.5, 0.1, 0.1]]], np.float32),
               "valid": np.asarray([[True, True, False]])}
    return {"images": img, "image_sizes": sizes, "text_features": text, "text_valid": valid,
            "targets": targets}


def test_train_step_grads_of_the_copies():
    """Copy 1 lowered by 100 (no proposal picks it), copy 0 as drawn: one
    step's loss and the copies' gradients against jax.grad's, copy 1's zero
    on both sides; the criterion's own arguments read no copy."""
    import inspect

    jm, _, flat, pm = _pair("ti", 2)
    flat, pm = _set_copy(flat, pm, 1, bias_shift=-100.0)
    batch = _batch()
    crit_kw = dict(num_classes=NUM_TEXT, num_queries=QUERIES, losses=("class", "boxes"))
    jcrit = j_criterion.DeformableCriterion(weight_dict=j_criterion.default_weight_dict(),
                                            **crit_kw)
    assert "ambiguous" not in inspect.getsource(j_criterion)
    targets = {k: jnp.asarray(v) for k, v in batch["targets"].items()}

    def jax_loss(p):
        out = jm.apply({"params": p}, *(jnp.asarray(batch[k]) for k in
                                        ("images", "image_sizes", "text_features",
                                         "text_valid")), align_on_fused=False)
        nb = jnp.clip(jnp.sum(targets["valid"].astype(jnp.float32)), 1.0)
        return jcrit.total(jcrit(jax.random.PRNGKey(0), out, targets, nb, None))

    total, grads = jax.jit(jax.value_and_grad(jax_loss))(unflatten(flat))
    want = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(grads).items()})

    pm = copy.deepcopy(pm).train()
    crit = DeformableCriterion(weight_dict=default_weight_dict(), **crit_kw)
    port_batch = {k: _t(v) for k, v in batch.items() if k != "targets"}
    port_batch["targets"] = {**{k: _t(v) for k, v in batch["targets"].items()},
                             "labels": _t(batch["targets"]["labels"]).long()}
    got_total, _, outputs = loss_fn(pm, crit, port_batch)
    got_total.backward()
    heads = outputs["first_stage_heads"]
    assert bool((heads == 1).any()) and not bool((heads == 2).any())
    np.testing.assert_allclose(got_total.item(), float(total), rtol=1e-4)
    copies = [(n, p) for n, p in pm.named_parameters() if "ambiguous" in n]
    assert len(copies) == 2 * (2 + 6)
    for name, p in copies:
        w = want[name].numpy()
        if ".1." in name.split("ambiguous")[1][:3]:
            assert p.grad is not None and not p.grad.any(), name
            assert not w.any(), name
            continue
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, atol=GRAD_RTOL * np.abs(w).max(),
                                   rtol=0, err_msg=name)
