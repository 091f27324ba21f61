"""Deformable-DETR R50's training and the R50 recipe's optimizer against
ape_tpu on the CPU, in f32:

* one train step of Deformable-DETR R50, single-stage and two-stage with
  box refinement (the Hungarian on every layer, class and boxes at 2 / 5 /
  2), against JAX's ``make_train_step``, as tests/test_torch_r50_train.py
  holds the other trees;
* the R50 recipe's optimizer (weight decay 1e-4, no layer decay, 0.1x on
  the backbone, the frozen stem decayed, FrozenBN untouched) against
  optax's chain for two steps, and the port's ``AdamW`` stepping a
  parameter without a gradient as optax steps a zero one.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax

from ape_tpu.engine import optimizer as j_optimizer
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.engine.optimizer import R50_RECIPE, build_optimizer
from tests.test_torch_r50_train import test_r50_train_step_matches_jax as _step_matches
from tests.torch_parity import flatten, jax_tiny_r50, model_pair, torch_tiny_r50, unflatten


@pytest.mark.parametrize("tree", ["detr", "detr_two_stage"])
def test_detr_r50_train_step_matches_jax(tree):
    """Deformable-DETR R50's step against JAX's, as
    ``test_r50_train_step_matches_jax`` holds it."""
    _step_matches(tree)


# the base lr of each case: the recipe's, at which the stem's decay (lr x
# 0.1 x 1e-4 a step) is below f32 rounding on both sides; and 0.1, at which
# it moves the stem
OPT_CASES = {"recipe": 2e-4, "stem_decays": 0.1}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_r50_optimizer_matches_optax(case):
    """Two AdamW steps of the R50 recipe (weight decay 1e-4, layer decay 1,
    0.1x on the backbone) from identical gradients, zero where the step
    stops them (the stem, FrozenBN), the port's stem without one, each
    clipped, against optax's chain: every parameter and buffer within 1e-6
    at the recipe's lr (at lr 0.1 the stem and FrozenBN alone, within 1e-6
    relative), FrozenBN unchanged, the stem stepped twice and decayed as
    optax decays it."""
    lr = OPT_CASES[case]
    jm, params, flat, pm = model_pair(jax_tiny_r50("ape"), torch_tiny_r50("ape"))
    pm = copy.deepcopy(pm)
    kw = dict(R50_RECIPE, base_lr=lr)
    tx = j_optimizer.build_optimizer(unflatten(flat), **kw)
    opt, sched = build_optimizer(pm, **kw)
    jparams = unflatten(flat)
    state = tx.init(jparams)
    update = jax.jit(lambda g, st, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, st, p)))
    named = dict(pm.named_parameters())
    init = {k: v.clone() for k, v in pm.state_dict().items()}
    rng = np.random.RandomState(7)
    stopped = {k for k in flat if k.startswith("backbone/") and ("norm" in k or "stem" in k)}
    stem = "backbone.stem.conv1.weight"
    for _ in range(2):
        grads = {k: (np.zeros_like(v) if k in stopped else rng.randn(*v.shape).astype(np.float32))
                 for k, v in flat.items()}
        jparams, state = update(unflatten(grads), state, jparams)
        for k, g in state_dict_from_jax(grads).items():
            if k in named:
                named[k].grad = None if k == stem else g.clone()
        torch.nn.utils.clip_grad_norm_(list(named.values()), 0.1)
        opt.step()
        sched.step()
    assert named[stem].grad is None and int(opt.state[named[stem]]["step"]) == 2
    done = {k: np.asarray(v) for k, v in flatten(jparams).items()}
    want = state_dict_from_jax({k: done.get(k, flat[k]) for k in flat})
    got = pm.state_dict()
    assert sorted(want) == sorted(got)
    check = [k for k in want if k.startswith("backbone.stem.")] if lr > 1e-3 else list(want)
    for k in check:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6,
                                   rtol=1e-6 if lr > 1e-3 else 0, err_msg=k)
    assert all(torch.equal(got[k], init[k]) for k in got if ".norm." in k and k.startswith("backbone."))
    assert torch.equal(got[stem], init[stem]) == (lr < 1e-3)


def test_adamw_steps_a_parameter_without_gradient():
    """The port's ``AdamW`` over a parameter the loss never reads: each step
    counts it (``state["step"]``), leaves its moments 0 and decays it alone,
    p *= 1 - lr x weight decay, as optax steps a zero gradient; its
    ``.grad`` is None again after every step. torch's own AdamW would
    neither count nor decay it."""
    from ape_tpu_torch.engine.optimizer import AdamW

    used, unused = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.full((3,), 2.0))
    opt = AdamW([{"params": [used, unused], "lr": 0.1, "weight_decay": 0.5}])
    want = unused.detach().clone()
    for step in (1, 2):
        opt.zero_grad(set_to_none=True)
        (used * used).sum().backward()
        opt.step()
        want = want * (1 - 0.1 * 0.5)
        st = opt.state[unused]
        assert unused.grad is None and int(st["step"]) == step
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
        torch.testing.assert_close(unused.detach(), want, rtol=0, atol=0)
    assert int(opt.state[used]["step"]) == 2
