"""The port's APE-L_D training path against ape_tpu on the CPU, in f32:

* ``DropPath`` against JAX's on the keep pattern JAX drew (read off its
  output): exact; the identity in ``eval()`` and at rate 0; the per-block
  rates against JAX's; the draw's keep rate within 4 sigma of 1 - rate;
* the federated class subset against JAX's ``_fed_class_mask`` on JAX's
  own uniforms, for every pad rule, logits wider than the weights and the
  binary first-stage head: identical masks; the class loss over it within
  rtol 1e-5; the port's LVIS weights against JAX's exactly;
* one whole train step of the tiny L_D (tests/torch_parity.L_D_VIT,
  L_D_FUSION; drop path 0, so neither side draws) against JAX's
  ``make_train_step`` (its gradients read off a recording optimizer), for
  name and phrase prompts, with and without recompute, with the federated
  loss off and on (the port handed JAX's uniforms): every loss term, the
  total and every parameter's gradient within the Ti step's bounds;
* the routing fault: the port's default step equals JAX's default step;
* the L_D learning-rate multipliers against JAX's by name, and three AdamW
  steps against optax.
"""

import copy
import inspect

import numpy as np
import optax
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from ape_tpu.data.datasets import metadata as j_metadata
from ape_tpu.engine import optimizer as j_optimizer
from ape_tpu.engine import train_step as j_train_step
from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu.modeling.ape_deta import transformer as j_transformer
from ape_tpu.modeling.backbone import eva_vit as j_vit
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.data.datasets.metadata import fed_loss_cls_weights
from ape_tpu_torch.engine.optimizer import lr_multiplier_tree
from ape_tpu_torch.engine.train_step import loss_fn, make_train_step
from ape_tpu_torch.modeling.ape_deta.criterion import (
    DeformableCriterion,
    default_weight_dict,
    fed_class_mask,
)
from ape_tpu_torch.modeling.backbone import eva_vit
from tests.test_torch_train import (
    LOSS_ATOL,
    NUM_TEXT,
    QUERIES,
    STAGE1_CAP,
    STAGE2_CAP,
    _grad_mismatches,
    _jax_targets,
    _optimizer_matches_optax,
    _port_batch,
    _port_targets,
    _positives,
    _slice_batch,
)
from tests.torch_parity import flatten, jax_tiny_l_d, model_pair, torch_tiny_l_d

# the federated subset of the step tests: few enough columns that the draw
# decides some (the tiny vocabulary has 8)
FED_SAMPLE = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _vit(**kw):
    return dict(patch_size=16, embed_dim=32, depth=3, num_heads=2, window_size=2,
                window_block_indexes=(0, 1), packed_swiglu=False, subln=True, **kw)


@pytest.mark.parametrize("case", ["eval_identity", "rate_0_identity", "jax_keep_pattern"])
def test_drop_path(rng, case):
    """eval_identity: a backbone built with drop path equals one without it
    in eval(). rate_0_identity: at rate 0 the block is the identity in
    train() too, with no mask drawn. jax_keep_pattern: JAX's DropPath
    (0.4) in training, its keep pattern read off its output (a kept sample
    is x / 0.6, a dropped one 0) and handed to the port's: exact in f32."""
    if case == "jax_keep_pattern":
        x = rng.randn(16, 3, 5, 6).astype(np.float32)
        want = np.asarray(j_vit.DropPath(0.4).apply({}, jnp.asarray(x), deterministic=False,
                                                     rngs={"dropout": jax.random.PRNGKey(5)}))
        keep = np.abs(want).reshape(16, -1).max(1) > 0
        assert 0 < keep.sum() < 16
        got = eva_vit.DropPath(0.4).train()(_t(x), _t(keep))
        np.testing.assert_array_equal(got.numpy(), want)
        return
    torch.manual_seed(0)
    plain = eva_vit.EVAViT(**_vit())
    dropping = eva_vit.EVAViT(**_vit(drop_path_rate=0.4 if case == "eval_identity" else 0.0))
    dropping.load_state_dict(plain.state_dict())
    x = _t(rng.randn(1, 64, 64, 3).astype(np.float32))
    if case == "rate_0_identity":
        plain.eval()
        dropping.train()
        state = torch.random.get_rng_state()
        with torch.no_grad():
            got = dropping(x)
        assert torch.equal(torch.random.get_rng_state(), state)  # nothing drawn
    else:
        plain.eval()
        with torch.no_grad():
            got = dropping.eval()(x)
    with torch.no_grad():
        torch.testing.assert_close(got, plain(x), rtol=0, atol=0)


def test_drop_path_rates_match_jax():
    """The per-block rates of L_D's 24 blocks at 0.4, as JAX's EVAViT gives
    its DropPath modules (read by intercepting them during init)."""
    kw = dict(embed_dim=32, depth=24, num_heads=2, window_size=2,
              window_block_indexes=tuple(i for i in range(24) if (i + 1) % 3), subln=True,
              inner_attn_ln=True, swiglu_subln=True, packed_swiglu=False, drop_path_rate=0.4)
    rates = {}

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, j_vit.DropPath):
            rates[context.module.path] = context.module.rate
        return next_fun(*args, **kwargs)

    jm = j_vit.EVAViT(img_size=32, patch_size=16, **kw)
    with nn.intercept_methods(record):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    pm = eva_vit.EVAViT(patch_size=16, **kw)
    got = {("blocks_%d" % i, f"drop_path{j}"): blk.drop_path.rate
           for i, blk in enumerate(pm.blocks) for j in (1, 2)}
    assert len(rates) == 48 and got == rates
    assert pm.drop_path_rates[0] == 0.0 and pm.drop_path_rates[-1] == pytest.approx(0.4)


def test_drop_path_draw_keeps_at_its_rate():
    """4000 draws at rate 0.4 keep 60 % within 4 sigma; a second generator
    of the same seed draws the same masks."""
    draw = [eva_vit.draw_keep([0.4], 2000, "cpu", torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert draw[0].shape == (1, 2, 2000) and draw[0].dtype == torch.bool
    assert torch.equal(draw[0], draw[1])
    sigma = (0.6 * 0.4 / 4000) ** 0.5
    assert abs(float(draw[0].float().mean()) - 0.6) < 4 * sigma


def test_drop_path_keeps_the_dropped_branch_in_the_graph():
    """A block whose both branches are dropped passes its input on, and its
    parameters still get (zero) gradients: the branch runs either way, so a
    step's kernel launches do not depend on the draw."""
    blk = eva_vit.Block(32, 2, 48, 0, subln=True, drop_path=0.5).train()
    x = torch.randn(2, 4, 4, 32, requires_grad=True)
    cos, sin = (torch.from_numpy(t) for t in eva_vit.rope_2d_table(8, 4, 16))
    out = blk(x, cos, sin, torch.zeros(2, 2, dtype=torch.bool))
    torch.testing.assert_close(out, x, rtol=0, atol=0)
    out.sum().backward()
    assert all(p.grad is not None and not p.grad.any() for p in blk.parameters())


# (num_classes, weights length, logits width, pad type) of each selection case
FED_CASES = {
    **{f"pad_{p}": (12, 9, 12, p) for p in ("default", "max", "max1000", "mean", "median", "cat")},
    "logits_wider_than_weights": (9, 9, 12, None),
    "binary_head": (12, 12, 1, None),
}


def _fed_case(rng, name):
    n_cls, n_w, c, pad = FED_CASES[name]
    pad = None if pad == "default" else pad
    weights = rng.uniform(1.0, 30.0, n_w).astype(np.float32)
    kw = dict(num_classes=n_cls, weight_dict={}, use_fed_loss=True, fed_loss_num_classes=4,
              fed_loss_cls_weights=weights, fed_loss_pad_type=pad)
    jcrit = j_criterion.DeformableCriterion(**{**kw, "fed_loss_cls_weights": jnp.asarray(weights)})
    crit = DeformableCriterion(**kw)
    cls = rng.randint(0, c, (2, 20))
    matched = rng.rand(2, 20) < 0.15
    return jcrit, crit, cls, matched, c


@pytest.mark.parametrize("case", list(FED_CASES))
def test_fed_class_mask_matches_jax(rng, case):
    """The port's selection on JAX's uniforms gives JAX's mask, and the
    padded weights are JAX's."""
    jcrit, crit, cls, matched, c = _fed_case(rng, case)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jcrit._fed_class_mask(key, jnp.asarray(cls), jnp.asarray(matched), c))
    u = np.asarray(jax.random.uniform(key, (c,), minval=1e-9, maxval=1.0))
    got = fed_class_mask(crit.fed_loss_cls_weights, _t(u), _t(cls), _t(matched), c,
                         crit.fed_loss_num_classes, crit._fed_pad_start)
    np.testing.assert_allclose(crit.fed_loss_cls_weights.numpy(),
                               np.asarray(jcrit.fed_loss_cls_weights), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(got.numpy(), want)
    gt = set(cls[matched].tolist())
    assert all(got[g] for g in gt)  # every ground-truth class kept
    if c > 1:
        assert int(got.sum()) < got.shape[0]  # and some column dropped


@pytest.mark.parametrize("case", ["pad_default", "binary_head"])
def test_fed_loss_class_matches_jax(rng, case):
    """loss_labels over the federated subset, on JAX's uniforms, within rtol
    1e-5; the binary head's loss summed once per kept column, as JAX's."""
    jcrit, crit, cls, matched, c = _fed_case(rng, case)
    b, k = cls.shape
    logits = rng.randn(b, k, c).astype(np.float32)
    assign = np.where(matched, rng.randint(0, 3, (b, k)), -1)
    labels = rng.randint(0, c, (b, 3))
    class_valid = np.ones((b, c), bool)
    key = jax.random.PRNGKey(11)
    want = jcrit.loss_labels({"pred_logits": jnp.asarray(logits)},
                             {"labels": jnp.asarray(labels)}, jnp.asarray(assign),
                             jnp.asarray(4.0), jnp.asarray(class_valid), key)["loss_class"]
    u = np.asarray(jax.random.uniform(key, (c,), minval=1e-9, maxval=1.0))
    got = crit.loss_labels({"pred_logits": _t(logits)}, {"labels": _t(labels).long()},
                           _t(assign), torch.tensor(4.0), _t(class_valid), {c: _t(u)})["loss_class"]
    plain = crit.loss_labels({"pred_logits": _t(logits)}, {"labels": _t(labels).long()},
                             _t(assign), torch.tensor(4.0), _t(class_valid))["loss_class"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert abs(float(got) - float(plain)) > 1e-3 * float(plain)


def test_lvis_fed_loss_weights_match_jax():
    """The port's copy of the LVIS counts gives JAX's weights, bit for bit;
    a dataset without a count table gets JAX's None."""
    want = j_metadata.fed_loss_cls_weights("lvis_v1_train")
    got = fed_loss_cls_weights("lvis_v1_train")
    assert len(got) == 1203 and got == want
    assert fed_loss_cls_weights("coco_2017_train") is None
    assert j_metadata.fed_loss_cls_weights("coco_2017_train") is None


@pytest.fixture(scope="module")
def l_d_pair():
    """ape_tpu and port tiny L_D with the same weights (the learned fusion
    token included, which the "text" fusion of training leaves unused)."""
    return model_pair(jax_tiny_l_d(), torch_tiny_l_d(), fusion_text_mode="learnable")


def _fed_weights():
    return np.random.RandomState(13).uniform(1.0, 30.0, NUM_TEXT).astype(np.float32)


def _criterion_kw(fed: bool):
    kw = dict(num_classes=NUM_TEXT, num_queries=QUERIES, losses=("class", "boxes"))
    if fed:
        kw.update(use_fed_loss=True, fed_loss_num_classes=FED_SAMPLE)
    return kw


def _recording_tx():
    """An optimizer that leaves the parameters as they are and keeps the
    step's gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


JAX_RNG = 0


def _jax_step(pair, prompt, fed):
    """JAX's make_train_step on the slice batch (prompt None: its default):
    metrics, gradients, the first-stage indices, and the federated
    uniforms its criterion draws, by logits width."""
    jm, params, _, _ = pair
    kw = _criterion_kw(fed)
    if fed:
        kw["fed_loss_cls_weights"] = jnp.asarray(_fed_weights())
    crit = j_criterion.DeformableCriterion(weight_dict=j_criterion.default_weight_dict(), **kw)
    batch = _slice_batch()
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items() if k != "targets"},
              "targets": _jax_targets(batch["targets"])}
    selected = []
    select = j_transformer.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    step = j_train_step.make_train_step(jm, crit, _recording_tx(),
                                        **({} if prompt is None else {"prompt": prompt}))
    rng = jax.random.PRNGKey(JAX_RNG)
    j_transformer.deta_first_stage_select = recording_select
    try:
        state, metrics = jax.jit(step)(j_train_step.create_train_state(params, _recording_tx()),
                                       jbatch, rng)
    finally:
        j_transformer.deta_first_stage_select = select
    r_fed = jax.random.split(rng, 4)[1]  # the criterion's split: match, fed, stage1, mask
    uniforms = {c: np.asarray(jax.random.uniform(r_fed, (c,), minval=1e-9, maxval=1.0))
                for c in (NUM_TEXT, 1)}
    grads = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(state.opt_state).items()})
    return dict(batch=batch, metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                selected=selected[-1], uniforms=uniforms)


@pytest.fixture(scope="module")
def jax_steps(l_d_pair):
    """JAX's steps by (prompt, fed), each run once."""
    cache = {}

    def get(prompt, fed):
        if (prompt, fed) not in cache:
            cache[prompt, fed] = _jax_step(l_d_pair, prompt, fed)
        return cache[prompt, fed]

    return get


def _port_criterion(fed: bool, uniforms=None):
    crit = DeformableCriterion(weight_dict=default_weight_dict(), **_criterion_kw(fed),
                               **({"fed_loss_cls_weights": _t(_fed_weights())} if fed else {}))
    if uniforms is not None:  # JAX's draw in place of the port's
        crit.draw_fed_uniforms = lambda widths, generator, device: {
            c: _t(uniforms[c]).to(device) for c in widths}
    return crit


@pytest.mark.parametrize("fed", [False, True], ids=["plain", "fed"])
@pytest.mark.parametrize("use_act_checkpoint", [False, True], ids=["no_recompute", "recompute"])
@pytest.mark.parametrize("prompt", ["name", "phrase"])
def test_l_d_train_step_loss_and_grads_match(l_d_pair, jax_steps, prompt, use_act_checkpoint,
                                             fed):
    """The port's loss_fn and backward against JAX's step: identical
    first-stage indices, every loss term, the total, and every parameter's
    gradient (the learned token, unused, gets none in the port and zeros in
    JAX)."""
    want = jax_steps(None if prompt == "name" else prompt, fed)
    assert inspect.signature(j_train_step.make_train_step).parameters["prompt"].default == "name"
    pm = copy.deepcopy(l_d_pair[3]).train()
    pm.transformer.encoder.use_act_checkpoint = use_act_checkpoint
    pm.transformer.decoder.use_act_checkpoint = use_act_checkpoint
    crit = _port_criterion(fed, want["uniforms"] if fed else None)
    total, losses, outputs = loss_fn(pm, crit, _port_batch(want["batch"]),
                                     torch.Generator().manual_seed(0), prompt)
    total.backward()
    np.testing.assert_array_equal(outputs["first_stage_indices"].numpy(), want["selected"])
    tg = _port_targets(want["batch"]["targets"])
    refs = outputs["init_reference"].detach()
    assert int(_positives(tg["boxes"], tg["valid"], refs, (0.6,), (0, 1)).max()) <= STAGE2_CAP
    enc = outputs["enc_outputs"]
    assert int(_positives(tg["boxes"], tg["valid"], enc["anchors"], (0.3, 0.7), (0, -1, 1),
                          enc["valid"]).max()) <= STAGE1_CAP
    metrics = want["metrics"]
    assert sorted(losses) == sorted(k for k in metrics if k != "total_loss")
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), metrics[k], atol=LOSS_ATOL, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(total.item(), metrics["total_loss"], rtol=1e-4)
    assert not _grad_mismatches(pm, want["grads"])
    # unused: the learned token, and under name prompts the last fusion
    # layer's language side, whose fused text no head reads
    unused = {n for n, p in pm.named_parameters() if p.grad is None}
    assert "name_prompt_fusion_feature" in unused
    assert (len(unused) > 1) if prompt == "name" else (len(unused) == 1)
    assert not any(want["grads"][n].any() for n in unused)
    assert all(torch.isfinite(p.grad).all() for p in pm.parameters() if p.grad is not None)
    # the text the heads aligned to: the original for name prompts
    moved = float((outputs["text_features"] - _t(want["batch"]["text_features"])).abs().max())
    assert (moved == 0.0) if prompt == "name" else (moved > 1e-2)


def test_default_step_routes_name_prompts_as_jax(l_d_pair, jax_steps):
    """The port's make_train_step with its defaults gives JAX's default
    step's losses on the tiny L_D: name prompts align the class logits to
    the original text (align_on_fused=False), not to the fused text."""
    want = jax_steps(None, False)["metrics"]
    pm = copy.deepcopy(l_d_pair[3])
    crit = _port_criterion(False)
    step = make_train_step(pm, crit, torch.optim.SGD(pm.parameters(), lr=0.0))
    got = step(_port_batch(_slice_batch()), torch.Generator().manual_seed(0))
    for k in ("loss_class", "loss_class_0", "loss_bbox", "total_loss"):
        np.testing.assert_allclose(float(got[k]), want[k], atol=LOSS_ATOL, rtol=1e-4, err_msg=k)


def test_l_d_lr_multipliers_match_jax(l_d_pair):
    """Every tiny L_D parameter's multiplier at JAX's L_D setting (24
    layers): blocks i -> decay^(L - i), the fusion layers, neck, heads and
    learned token 1, sampling offsets 0.1x; by name through the converter."""
    _, params, flat, pm = l_d_pair
    mults = flatten(j_optimizer.lr_multiplier_tree(params, num_layers=24))
    want = state_dict_from_jax({k: np.full(flat[k].shape, float(v), np.float32)
                                for k, v in mults.items()})
    got = lr_multiplier_tree(pm, 24)
    assert sorted(got) == sorted(want)
    for name, m in got.items():
        np.testing.assert_allclose(want[name].numpy(), np.float32(m), rtol=1e-6, err_msg=name)
    assert got["transformer.encoder.vl_layers.0.b_attn.gamma_v"] == 1.0
    assert got["name_prompt_fusion_feature"] == 1.0
    assert got["backbone.net.blocks.2.attn.q_proj.weight"] == pytest.approx(0.8 ** 22)


def test_l_d_optimizer_matches_optax(l_d_pair):
    """Three AdamW steps from identical gradients, against optax's chain:
    the fusion layers and the learned token land in JAX's groups."""
    _optimizer_matches_optax(l_d_pair)
