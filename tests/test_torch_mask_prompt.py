"""The port's mask prompt against ape_tpu's on the CPU, in f32: a (B, H, W)
bool over the padded image that ``APEDeta`` subsamples to each level by
``[:, ::H // H_l, ::W // W_l]`` and the first stage ANDs into its
proposals' validity (JAX's model.py:187-194, transformer.py:125-160).

* a tiny model with a random prompt and with a quarter-image prompt:
  logits, boxes and the first stage within 1e-4 of JAX's, identical
  first-stage indices and validity; of the proposals the prompt leaves
  out, at most one a level is selected (they compete in the select with
  one shared score and box, and NMS keeps one of them);
* ``gen_output_proposals``: ``proposal_valid`` is ``in_range & valid &
  prompt``, equal to JAX's, as the masked memory; the anchors within an
  f32 ulp;
* an all-True prompt equals no prompt bit for bit;
* levels of 3 and 2 cells on a 192^2 canvas subsample as JAX does, and a
  level whose size does not divide the canvas fails in both;
* the port's DefaultPredictor sets the key as JAX's does, and APE's
  outputs do not change with it (ROADMAP Queue 3, trait 6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.parity_harness import DIMS, FakeLanguage
from tests.torch_parity import jax_tiny_protocol, model_pair, tiny_inputs, torch_tiny_protocol

ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


_PAIRS = {}


def _pair(img=DIMS["img"]):
    """ape_tpu and port tiny protocol models for an img^2 canvas."""
    if img not in _PAIRS:
        d = dict(DIMS, img=img)
        jm, params, flat, pm = model_pair(jax_tiny_protocol(d), torch_tiny_protocol(d))
        _PAIRS[img] = (d, jm, params, pm)
    return _PAIRS[img]


def _run_both(img, prompt, h=None, w=None):
    """(JAX's outputs and first-stage indices, the port's outputs in train()
    mode) with ``prompt`` (1, img, img) bool."""
    import ape_tpu.modeling.ape_deta.transformer as jt

    d, jm, params, pm = _pair(img)
    inputs = tiny_inputs(d, h=h, w=w)
    selected = []
    select = jt.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    jt.deta_first_stage_select = recording_select
    try:
        want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a[:4], mask_prompt=a[4]))(
            params, *(jnp.asarray(a) for a in inputs), jnp.asarray(prompt))
    finally:
        jt.deta_first_stage_select = select
    pm.train()
    with torch.no_grad():
        got = pm(*(_t(a) for a in inputs), mask_prompt=_t(prompt))
    return want, selected[-1], got


def _check(want, sel, got):
    np.testing.assert_array_equal(got["enc_outputs"]["valid"].numpy(),
                                  np.asarray(want["enc_outputs"]["valid"]))
    np.testing.assert_array_equal(got["first_stage_indices"].numpy(), sel)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got["enc_outputs"][key].numpy(),
                                   np.asarray(want["enc_outputs"][key]), atol=ATOL, err_msg=key)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("prompt", ["random", "quarter"])
def test_mask_prompt_matches_ape_tpu(rng, prompt):
    """A random prompt (70 % of the pixels) or the upper-left quarter, on a
    padded image: the prompt removes valid proposals, and every output
    agrees with JAX's."""
    img = DIMS["img"]
    if prompt == "random":
        mask = rng.rand(1, img, img) > 0.3
    else:
        mask = np.zeros((1, img, img), bool)
        mask[:, : img // 2, : img // 2] = True
    want, sel, got = _run_both(img, mask, h=200, w=240)
    _check(want, sel, got)
    _, _, pm = _pair()[1:]
    with torch.no_grad():
        free = pm(*(_t(a) for a in tiny_inputs(h=200, w=240)))
    valid, free_valid = got["enc_outputs"]["valid"], free["enc_outputs"]["valid"]
    assert bool((valid <= free_valid).all()) and int(valid.sum()) < int(free_valid.sum())
    # invalid proposals compete in the select (JAX's, as the reference's):
    # they share one zeroed-memory score and one saturated box, so NMS keeps
    # at most one of them a level
    sel = got["first_stage_indices"][0]
    picked_invalid = sel[~valid[0, sel]]
    levels = torch.bucketize(picked_invalid, torch.tensor([1024, 1280, 1344, 1360]), right=True)
    assert len(set(levels.tolist())) == len(levels) and len(levels) < len(sel) // 2


def test_proposal_valid_is_range_and_padding_and_prompt(rng):
    """gen_output_proposals with a prompt: every output equal to JAX's, and
    proposal_valid = in_range & valid & prompt."""
    from ape_tpu.modeling.ape_deta import transformer as jt
    from ape_tpu_torch.modeling.ape_deta import transformer as pt

    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    memory = rng.randn(2, s, 8).astype(np.float32)
    valid = rng.rand(2, s) > 0.2
    ratios = rng.uniform(0.6, 1.0, (2, 3, 2)).astype(np.float32)
    prompt = rng.rand(2, s) > 0.4
    want = jt.gen_output_proposals(jnp.asarray(memory), jnp.asarray(valid), shapes,
                                   jnp.asarray(ratios), jnp.asarray(prompt))
    got = pt.gen_output_proposals(_t(memory), _t(valid), shapes, _t(ratios), _t(prompt))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)  # f32 ulps
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # in range: valid with no padding and no prompt
    in_range = pt.gen_output_proposals(_t(memory), torch.ones(2, s, dtype=torch.bool), shapes,
                                       _t(ratios))[2]
    assert not bool(in_range.all())
    assert torch.equal(got[2], in_range & _t(valid) & _t(prompt))
    assert bool((in_range & _t(valid) & ~_t(prompt)).any())


def test_all_true_prompt_is_no_prompt():
    """An all-True prompt gives every output of no prompt, bit for bit."""
    _, _, _, pm = _pair()
    inputs = [_t(a) for a in tiny_inputs(h=200, w=240)]
    pm.eval()
    with torch.no_grad():
        free = pm(*inputs)
        full = pm(*inputs, mask_prompt=torch.ones(1, DIMS["img"], DIMS["img"], dtype=torch.bool))
    assert sorted(free) == sorted(full)
    for k in free:
        assert torch.equal(free[k], full[k]), k


def test_levels_of_three_and_two_cells_subsample_as_jax(rng):
    """A 192^2 canvas: the protocol pyramid's levels 24, 12, 6, 3 and 2
    subsample by strides 8, 16, 32, 64 and 96; outputs as JAX's."""
    from ape_tpu_torch.modeling.ape_deta.model import flatten_mask_prompt

    mask = rng.rand(1, 192, 192) > 0.5
    want, sel, got = _run_both(192, mask)
    _check(want, sel, got)
    flat = flatten_mask_prompt(_t(mask), [(24, 24), (12, 12), (6, 6), (3, 3), (2, 2)])
    pieces = [mask[:, ::s, ::s].reshape(1, -1) for s in (8, 16, 32, 64, 96)]
    np.testing.assert_array_equal(flat.numpy(), np.concatenate(pieces, 1))


def test_a_level_that_does_not_divide_fails_as_in_jax():
    """A 208^2 canvas: its 6^2 level takes every 34th row, 7 of them, where
    JAX fails on the shapes (1, 894) and (1, 914); so does the port."""
    d, jm, params, pm = _pair(208)
    inputs = tiny_inputs(d)
    prompt = np.ones((1, 208, 208), bool)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jm.apply({"params": params}, *(jnp.asarray(a) for a in inputs),
                 mask_prompt=jnp.asarray(prompt))
    with torch.no_grad(), pytest.raises(ValueError, match="must divide"):
        pm(*(_t(a) for a in inputs), mask_prompt=_t(prompt))


def test_predictor_sets_the_key_and_ape_does_not_read_it():
    """Both predictors put the mask prompt into the input as given; the
    port's APE answers the same with and without it."""
    from ape_tpu.engine.defaults import DefaultPredictor as JPredictor
    from ape_tpu_torch.engine import APE, DefaultPredictor

    class Recorder:
        device = torch.device("cpu")

        def __call__(self, batched_inputs):
            self.inputs = batched_inputs
            return [{}]

    image = np.random.RandomState(1).randint(0, 256, (60, 80, 3)).astype(np.uint8)
    prompt = np.zeros((60, 80), bool)
    prompt[:30, :40] = True
    for predictor_cls in (DefaultPredictor, JPredictor):
        rec = Recorder()
        predictor_cls(rec, image_size=DIMS["img"])(image, "cat", mask_prompt=prompt)
        assert rec.inputs[0]["mask_prompt"] is prompt
        predictor_cls(rec, image_size=DIMS["img"])(image, "cat")
        assert "mask_prompt" not in rec.inputs[0]

    _, _, _, pm = _pair()
    feats = np.random.RandomState(5).randn(DIMS["num_text"], DIMS["ldim"]).astype(np.float32)
    ape = APE(pm.eval(), FakeLanguage(feats), semantic_on=False)
    img, sizes, _, _ = tiny_inputs(h=200, w=240)
    inp = {"image": img[0], "image_size": sizes[0], "text_prompt": "cat, dog, bus"}
    plain = ape([dict(inp)])[0]
    prompted = ape([dict(inp, mask_prompt=np.zeros((DIMS["img"], DIMS["img"]), bool))])[0]
    for k in ("boxes", "scores", "classes"):
        assert torch.equal(plain["instances"][k], prompted["instances"][k]), k
