"""The port's ResNet-50 family against ape_tpu on the CPU, in f32 (and the
FrozenBN rounding in bf16):

* the FrozenBN ResNet-50 alone: res2-res5 within 1e-5 of each output's
  largest entry in f32; FrozenBN in bf16 within one bf16 step of JAX's
  element by element; the ResNet in bf16 beside JAX's in bf16; FrozenBN
  statistics drawn far from identity, so that a mean and variance swapped
  in the port lands far outside the bound;
* the neck over res3-res5 (512, 1024 and 2048 channels) with its two
  stride-2 extras;
* each tiny R50 tree's forward (tests/torch_parity.R50_TREES: APE-DETA R50
  masked and not, its fusion tree, DETA R50's class bank, Deformable-DETR
  R50 single-stage, with box refinement and two-stage): logits, boxes and
  masks within 1e-4, DETA's first-stage selection identical;
(tests/test_torch_r50_convert.py: the weight round trip, the builders'
device rule and the Hungarian matcher.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.modeling.backbone import resnet as j_resnet
from ape_tpu_torch.modeling.backbone import resnet
from tests.torch_parity import (
    R50_DIMS,
    R50_NECK_IN,
    R50_TREES,
    init_params,
    jax_tiny_r50,
    load_port,
    model_pair,
    tiny_inputs,
    torch_tiny_r50,
)

RESNET_F32_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def resnet_pair():
    """JAX's ResNet-50 and the port's with the same seeded weights (fan-in
    kernels, FrozenBN scales near 1, means N(0, 0.5), variances U(0.5, 2)),
    and a 64^2 image."""
    img = np.random.RandomState(4).randn(1, 64, 64, 3).astype(np.float32)
    jm = j_resnet.ResNet(depth=50, freeze_at=1)
    flat, params = init_params(jm, jnp.asarray(img))
    pm = load_port(resnet.ResNet(), {f"backbone/{k}": v for k, v in flat.items()},
                   "", "backbone.")
    return jm, params, pm, img


def _rel_errs(got, want):
    return {k: float(np.abs(got[k].float().numpy() - np.asarray(want[k], np.float32)).max())
            / float(np.abs(np.asarray(want[k], np.float32)).max()) for k in want}


def test_resnet_matches_jax_f32(resnet_pair):
    """res2-res5: shapes, channels, and values within RESNET_F32_RTOL of each
    output's largest entry."""
    jm, params, pm, img = resnet_pair
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        got = pm(_t(img))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "res2": (1, 16, 16, 256), "res3": (1, 8, 8, 512), "res4": (1, 4, 4, 1024),
        "res5": (1, 2, 2, 2048)}
    assert pm.out_channels == {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}
    errs = _rel_errs(got, want)
    assert max(errs.values()) <= RESNET_F32_RTOL, errs


def test_resnet_swapped_statistics_show(resnet_pair):
    """The bound's power: the port with every FrozenBN's mean and variance
    swapped (the variance as |mean| + 0.5, to stay positive) lands far
    outside RESNET_F32_RTOL."""
    import copy

    jm, params, pm, img = resnet_pair
    bad = copy.deepcopy(pm)
    for m in bad.modules():
        if isinstance(m, resnet.FrozenBatchNorm):
            m.running_mean, m.running_var = m.running_var.clone(), m.running_mean.abs() + 0.5
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        errs = _rel_errs(bad(_t(img)), want)
    assert min(errs.values()) > 1e3 * RESNET_F32_RTOL, errs


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x|: 2^(exponent - 7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


def test_frozen_bn_bf16_rounds_as_jax(rng):
    """FrozenBN of a bf16 input against JAX's in bf16: every element within
    one bf16 step of JAX's (mul and add rounded to bf16, the product rounded,
    then the sum); in f32 within 1e-6."""
    c = 64
    x = rng.randn(2, 5, 6, c).astype(np.float32) * 3
    consts = {"scale": 1 + 0.3 * rng.randn(c), "bias": rng.randn(c), "mean": rng.randn(c),
              "var": rng.uniform(0.2, 3.0, c)}
    consts = {k: v.astype(np.float32) for k, v in consts.items()}
    bn = resnet.FrozenBatchNorm(c)
    for jk, tk in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                   ("var", "running_var")):
        getattr(bn, tk).copy_(_t(consts[jk]))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jbn = j_resnet.FrozenBatchNorm(c, dtype=jdtype)
        want = np.asarray(jax.jit(jbn.apply)({"params": {k: jnp.asarray(v) for k, v in consts.items()}},
                                             jnp.asarray(x, jdtype)).astype(jnp.float32))
        got = bn(_t(x).to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert np.all(np.abs(got - want) <= _bf16_step(want)), float(np.abs(got - want).max())


def test_resnet_bf16_beside_jax(resnet_pair):
    """The ResNet in bf16 against JAX's in bf16 on the same weights: both
    round 53 convolutions, so each output is held within 3e-2 of its largest
    entry (what the two orders of bf16 rounding leave), and the bf16 gap to
    the f32 outputs is of that size on both sides."""
    jm, params, pm, img = resnet_pair
    jbf = j_resnet.ResNet(depth=50, freeze_at=1, dtype=jnp.bfloat16)
    want = jax.jit(jbf.apply)({"params": params}, jnp.asarray(img))
    want32 = jax.jit(jm.apply)({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        got = pm(_t(img).to(torch.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    errs = _rel_errs(got, {k: np.asarray(v.astype(jnp.float32)) for k, v in want.items()})
    jax_gap = _rel_errs({k: _t(np.asarray(v.astype(jnp.float32))) for k, v in want.items()},
                        want32)
    assert max(errs.values()) <= 3e-2, errs
    assert max(errs.values()) <= 4 * max(jax_gap.values()), (errs, jax_gap)


def test_resnet_freeze_at_stops_the_stem_gradient(resnet_pair):
    """freeze_at=1: the stem's convolution gets no gradient, res2's does;
    the FrozenBN constants are buffers, never parameters."""
    import copy

    pm = copy.deepcopy(resnet_pair[2])
    out = pm(_t(resnet_pair[3]))
    sum(v.sum() for v in out.values()).backward()
    assert pm.stem.conv1.weight.grad is None
    assert pm.res2[0].conv1.weight.grad.abs().max() > 0
    assert not any("norm" in n for n, _ in pm.named_parameters())
    assert sum("running_var" in n for n, _ in pm.named_buffers()) == 53


def test_channel_mapper_matches_jax(rng):
    """The neck over res3-res5 (512, 1024, 2048 channels) with its two
    stride-2 extras, the first on the raw res5: within 1e-5."""
    from ape_tpu.modeling.ape_deta.model import ChannelMapper as JMapper
    from ape_tpu_torch.modeling.ape_deta.model import ChannelMapper

    feats = {n: rng.randn(2, s, s, c).astype(np.float32)
             for n, s, c in zip(R50_NECK_IN, (32, 16, 8), (512, 1024, 2048))}
    jm = JMapper(out_channels=64, in_features=R50_NECK_IN, num_outs=5)
    flat, params = init_params(jm, {k: jnp.asarray(v) for k, v in feats.items()})
    pm = load_port(ChannelMapper(R50_NECK_IN, (512, 1024, 2048), 64, num_outs=5),
                   {f"neck/{k}": v for k, v in flat.items()}, "", "neck.")
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        got = pm({k: _t(v) for k, v in feats.items()})
    assert sorted(got) == sorted(want) == sorted(R50_NECK_IN + ("extra0", "extra1"))
    assert tuple(got["extra0"].shape) == (2, 4, 4, 64) and pm.extra_convs[0].conv.in_channels == 2048
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("tree", list(R50_TREES))
def test_r50_forward_matches_jax(tree, monkeypatch):
    """Each tiny R50 tree on the same weights: logits, boxes and masks within
    1e-4, DETA's first-stage selection identical; a class bank's logits
    over its own classes whatever text is passed."""
    import ape_tpu.modeling.ape_deta.transformer as jt

    selected = []
    select = jt.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    monkeypatch.setattr(jt, "deta_first_stage_select", recording_select)
    jm, params, _, pm = model_pair(jax_tiny_r50(tree), torch_tiny_r50(tree))
    inputs = tiny_inputs(R50_DIMS)
    want = jax.jit(jm.apply)({"params": params}, *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        got = pm(*(_t(a) for a in inputs))
    keys = ["pred_logits", "pred_boxes"] + (["pred_masks"] if pm.mask_on else [])
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    classes = R50_TREES[tree][1].get("num_learned_classes") or inputs[2].shape[1]
    assert got["pred_logits"].shape == (1, R50_DIMS["queries"], classes)
    two_stage = R50_TREES[tree][0].get("as_two_stage", True)
    assert ("first_stage_indices" in got) == two_stage
    if R50_TREES[tree][0].get("assign_first_stage", True):
        np.testing.assert_array_equal(got["first_stage_indices"].numpy(), selected[-1])
    if "num_learned_classes" in R50_TREES[tree][1]:
        other = (inputs[0], inputs[1], 5 * inputs[2] + 1, inputs[3])
        with torch.no_grad():
            again = pm(*(_t(a) for a in other))
        torch.testing.assert_close(again["pred_logits"], got["pred_logits"], rtol=0, atol=0)
