"""The encoder's recompute policy (JAX's ``msda_out`` remat policy) on the
CPU, in f32, at the parity-harness dims (2 + 2 layers):

* under ``REMAT_POLICY = "msda"`` (the default) each encoder layer's
  window-MSDA forward runs once a step, under "full" twice (forward and
  recompute), counted at the operator; the decoder's exact MSDA runs twice
  under both, and the fusion, encoder and decoder layers run their forwards
  twice under both;
* an exact-mode layer under the encoder's policy saves nothing;
* the loss and every gradient are bit for bit the same under both policies;
* the "msda" step's loss and gradients equal JAX's step with its default
  ``_remat_policy()`` (``use_act_checkpoint`` on), within the Ti step's
  bounds (``tests/test_torch_train.py``);
* the plain MSDA backward, the CPU path of ``ape::msda_bwd``, equals
  autograd of the plain forward within f32 rounding.
"""

import collections
import contextlib
import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_train import (
    LOSS_ATOL,
    _grad_mismatches,
    _jax_step,
    _port_batch,
    _slice_batch,
)
from tests.torch_parity import jax_tiny, model_pair, torch_tiny, torch_tiny_l_d

from ape_tpu_torch.engine.train_step import loss_fn
from ape_tpu_torch.modeling.ape_deta import transformer as port_transformer
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from ape_tpu_torch.ops import msda_dispatch
from ape_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_backward

from tests.parity_harness import DIMS

LAYERS = DIMS["layers"]
NUM_TEXT = DIMS["num_text"] + 1


class OpCounter(TorchDispatchMode):
    """Counts the MSDA operators that run: the forward by its form ("gather":
    the encoder's window op, "exact": the decoder's), and the backward."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.ape.msda_fwd.default:
            self.calls[args[4]] += 1
        elif func is torch.ops.ape.msda_bwd.default:
            self.calls["bwd"] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def remat_pair():
    """The tiny protocol models with the encoder recomputed on both sides
    (JAX: ``nn.remat(EncoderLayer, policy=_remat_policy())``)."""
    return model_pair(jax_tiny(fusion={"use_act_checkpoint": True}),
                      torch_tiny(fusion={"use_act_checkpoint": True}))


def _step(pm, batch, policy, monkeypatch, counter=None, layer_calls=None):
    """One step's loss and gradients under ``policy``, encoder and decoder
    recomputed; ``layer_calls`` counts each layer kind's forwards."""
    monkeypatch.setattr(msda_dispatch, "REMAT_POLICY", policy)
    pm = copy.deepcopy(pm).train()
    pm.transformer.encoder.use_act_checkpoint = True
    pm.transformer.decoder.use_act_checkpoint = True
    hooks = []
    if layer_calls is not None:
        groups = {"encoder": pm.transformer.encoder.layers, "decoder": pm.transformer.decoder.layers,
                  "fusion": pm.transformer.encoder.vl_layers or ()}
        for kind, layers in groups.items():
            for layer in layers:
                hooks.append(layer.register_forward_pre_hook(
                    lambda *_, k=kind: layer_calls.update([k])))
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=DIMS["queries"],
                               weight_dict=default_weight_dict())
    with counter if counter is not None else contextlib.nullcontext():
        total, _, _ = loss_fn(pm, crit, _port_batch(batch))
        total.backward()
    for h in hooks:
        h.remove()
    return total, {n: p.grad for n, p in pm.named_parameters()}


@pytest.mark.parametrize("policy,encoder_fwd", [("msda", LAYERS), ("full", 2 * LAYERS)])
def test_encoder_msda_forward_runs_once_under_msda(remat_pair, monkeypatch, policy, encoder_fwd):
    """The encoder's window forward: once a layer under "msda", twice under
    "full"; the decoder's exact forward twice a layer and one backward a
    layer each under both."""
    counter = OpCounter()
    _step(remat_pair[3], _slice_batch(), policy, monkeypatch, counter)
    assert counter.calls == {"gather": encoder_fwd, "exact": 2 * LAYERS, "bwd": 2 * LAYERS}


@pytest.mark.parametrize("policy", ["msda", "full"])
def test_layers_recompute_under_both_policies(monkeypatch, policy):
    """On the tiny L_D (a fusion layer before each encoder layer) every
    fusion, encoder and decoder layer runs its forward twice under either
    policy: the policy keeps one output, not a layer."""
    torch.manual_seed(0)
    pm = torch_tiny_l_d()
    calls = collections.Counter()
    counter = OpCounter()
    _step(pm, _slice_batch(), policy, monkeypatch, counter, calls)
    assert calls == {"fusion": 2 * LAYERS, "encoder": 2 * LAYERS, "decoder": 2 * LAYERS}
    want = LAYERS if policy == "msda" else 2 * LAYERS
    assert counter.calls == {"gather": want, "exact": 2 * LAYERS, "bwd": 2 * LAYERS}


def test_exact_mode_saves_nothing(remat_pair, monkeypatch):
    """A layer whose MSDA runs in exact mode, recomputed under the encoder's
    "msda" context, runs that forward again in the recompute."""
    monkeypatch.setattr(msda_dispatch, "REMAT_POLICY", "msda")
    pm = copy.deepcopy(remat_pair[3])
    layer = pm.transformer.decoder.layers[0]
    g = torch.Generator().manual_seed(0)
    shapes = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
    s = sum(h * w for h, w in shapes)
    x = torch.randn(1, 6, DIMS["embed"], generator=g, requires_grad=True)
    memory = torch.randn(1, s, DIMS["embed"], generator=g)
    refs = torch.rand(1, 6, 5, 4, generator=g) * 0.5 + 0.25
    counter = OpCounter()
    with counter:
        out = port_transformer._run_layer(
            layer, True, x, torch.zeros_like(x), memory, torch.ones(1, s, dtype=torch.bool),
            shapes, refs, context_fn=msda_dispatch.remat_context_fn())
        out.sum().backward()
    assert counter.calls == {"exact": 2, "bwd": 1}


def test_policies_give_identical_steps(remat_pair, monkeypatch):
    """Loss and every parameter's gradient bit for bit under both policies:
    the kept output is the tensor the recompute would have made."""
    batch = _slice_batch()
    total_m, grads_m = _step(remat_pair[3], batch, "msda", monkeypatch)
    total_f, grads_f = _step(remat_pair[3], batch, "full", monkeypatch)
    assert torch.equal(total_m, total_f)
    assert grads_m.keys() == grads_f.keys()
    for name, g in grads_m.items():
        assert (g is None) == (grads_f[name] is None), name
        assert g is None or torch.equal(g, grads_f[name]), name


@pytest.fixture(scope="module")
def jax_remat_step(remat_pair):
    """JAX's step with the encoder under ``nn.remat`` and its default policy
    (``save_only_these_names("msda_out")``)."""
    import os

    assert os.environ.get("APE_REMAT_POLICY", "msda") != "full"
    return _jax_step(remat_pair, _slice_batch(), ("class", "boxes"))


def test_msda_step_matches_jax_default_policy(remat_pair, jax_remat_step, monkeypatch):
    """The "msda" step's loss terms, total and every gradient against JAX's
    recomputed step, within the Ti step's bounds (GRAD_RTOL of each
    parameter's largest entry)."""
    batch = jax_remat_step["batch"]
    monkeypatch.setattr(msda_dispatch, "REMAT_POLICY", "msda")
    pm = copy.deepcopy(remat_pair[3]).train()
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=DIMS["queries"],
                               weight_dict=default_weight_dict())
    pm.zero_grad()
    counter = OpCounter()
    with counter:
        total, losses, outputs = loss_fn(pm, crit, _port_batch(batch))
        total.backward()
    assert counter.calls["gather"] == LAYERS
    np.testing.assert_array_equal(outputs["first_stage_indices"].numpy(),
                                  jax_remat_step["selected"])
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), jax_remat_step["losses"][k], atol=LOSS_ATOL,
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total.item(), jax_remat_step["total"], rtol=1e-4)
    assert not _grad_mismatches(pm, jax_remat_step["grads"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_equals_autograd(dtype):
    """``ms_deform_attn_backward`` against autograd of ``ms_deform_attn`` on
    locations inside, on the edge and outside the levels: d_value and d_att
    within 1e-6 and d_loc within 1e-6 of its largest entry (f32 sums in
    another order), in the inputs' dtypes."""
    g = torch.Generator().manual_seed(0)
    shapes = ((8, 6), (4, 3), (2, 2))
    s = sum(h * w for h, w in shapes)
    value = torch.randn(2, s, 2, 8, generator=g).to(dtype).requires_grad_()
    loc = (torch.rand(2, 5, 2, 3, 4, 2, generator=g) * 1.4 - 0.2).requires_grad_()
    att = torch.rand(2, 5, 2, 3, 4, generator=g).to(dtype).requires_grad_()
    out = ms_deform_attn(value, shapes, loc, att)
    grad = torch.randn(out.shape, generator=g).to(dtype)
    want = torch.autograd.grad(out, (value, loc, att), grad)
    got = ms_deform_attn_backward(value.detach(), shapes, loc.detach(), att.detach(), grad)
    for name, w, t in zip(("d_value", "d_loc", "d_att"), want, got):
        assert t.dtype == w.dtype, name
        err = float((t.float() - w.float()).abs().max())
        assert err <= 1e-6 * max(1.0, float(w.float().abs().max())), (name, err)
