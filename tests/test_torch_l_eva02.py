"""The port's APE-L (the non-CLIP EVA-02-L tree of
``configs/common/backbone/vitl_eva02.py``) against ape_tpu's on the CPU:

* ``build_ape_l``'s settings against the configs' own: the backbone's
  (window 16, every sixth block global, pretrained at 224, no inner LN,
  SwiGLU unpacked, drop path 0.4) and the model's (900 queries, no
  recompute; the _vlf_ twin's fusion and encoder recompute);
* a tiny non-CLIP EVAViT (window 4, block 5 global) within 1e-4 of JAX's
  with the same flags in f32; in bf16, as far from JAX's bf16 output and
  from the f32 one as twice JAX's own bf16 rounding (its distance to f32);
* the weight round trip over the full-size tree that JAX instantiates from
  the ADE20k panoptic config, exact, loaded strictly into build_ape_l;
* the tiny model and its _vlf_ twin: logits and boxes within 1e-4 of
  JAX's, mask logits within 1e-4 of their largest entry, first-stage
  indices identical; one f32 train step (masked
  losses) against ``jax.value_and_grad``: every loss term and every
  parameter's gradient within 2e-3 of its own largest entry, as the Ti
  step tests;
* the configs' 768-wide, 12-layer text tower at narrow widths (12 heads)
  against JAX's, and the language weights' round trip at its full widths.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.config import LazyConfig, instantiate
from ape_tpu.modeling.ape_deta import criterion as j_criterion
from ape_tpu.modeling.backbone import eva_vit as j_vit
from ape_tpu_torch.checkpoint.convert import language_state_dict_from_jax, state_dict_from_jax
from ape_tpu_torch.engine.train_step import loss_fn
from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
from ape_tpu_torch.modeling.backbone import eva_vit
from ape_tpu_torch.modeling.build import build_ape_l
from ape_tpu_torch.ops.bounds import bf16_steps
from tests.parity_harness import DIMS
from tests.torch_parity import (
    L_VIT,
    flatten,
    init_params,
    jax_tiny_l,
    load_port,
    model_pair,
    tiny_inputs,
    torch_tiny_l,
)

ATOL = 1e-4
GRAD_RTOL = 2e-3
ADE = "configs/ADE20k_PanopticSegmentation/ape_deta/ape_deta_vitl_eva02{}_lsj1024.py"


def _t(x):
    return torch.from_numpy(np.array(x))


def _meta_model(**kw):
    """build_ape_l at full size with no storage: its structure only."""
    with torch.device("meta"):
        return build_ape_l(device="meta", **kw)


@pytest.mark.parametrize("vlf", ["", "_vlf"])
def test_build_ape_l_settings_match_the_configs(vlf):
    cfg = LazyConfig.load(ADE.format(vlf))
    net_cfg = cfg.model.backbone.net
    model = _meta_model(vl_fusion=bool(vlf))
    net = model.backbone.net
    assert net_cfg.window_size == net.window_size == 16
    assert tuple(net_cfg.window_block_indexes) == net.window_block_indexes
    assert [i for i in range(24) if i not in net.window_block_indexes] == [5, 11, 17, 23]
    assert net.pos_embed.shape == (1, (net_cfg.pretrain_img_size // 16) ** 2 + 1, 1024)
    assert (net_cfg.embed_dim, net_cfg.depth, net_cfg.num_heads) == (
        net.embed_dim, len(net.blocks), net.num_heads)
    assert max(net.drop_path_rates) == pytest.approx(net_cfg.drop_path_rate)
    jax_net = j_vit.EVAViT(**{k: v for k, v in net_cfg.items() if k != "_target_"})
    for block in net.blocks:  # subln, no inner LN, SwiGLU unpacked with ffn_ln
        assert block.attn.subln is jax_net.subln is True
        assert block.attn.inner_attn_ln is None and jax_net.inner_attn_ln is False
        assert not block.mlp.packed and jax_net.packed_swiglu is False
        assert block.mlp.ffn_ln is not None and jax_net.swiglu_subln is True
    tr, enc = cfg.model.transformer, cfg.model.transformer.encoder
    assert model.transformer.two_stage_num_proposals == cfg.model.num_queries == 900
    assert model.mask_on is cfg.model.mask_on is True
    assert bool(model.transformer.encoder.use_act_checkpoint) == bool(
        enc.get("use_act_checkpoint", False)) == bool(vlf)
    assert model.transformer.decoder.use_act_checkpoint is False
    assert (model.transformer.encoder.vl_layers is not None) == bool(enc.vl_fusion) == bool(vlf)
    if vlf:
        fuse = build_ape_l(vl_fusion=True, depth=1, num_layers=1,
                           device="cpu").transformer.encoder.vl_layers[0].b_attn
        assert float(fuse.gamma_v[0]) == pytest.approx(enc.vl_init_values)
        assert fuse.attn.v_proj.weight.shape[0] == enc.vl_embed_dim == 2048
    assert tr.decoder.get("proposal_ambiguous", 0) == 0
    assert cfg.language == {**cfg.language, "width": 768, "heads": 12, "layers": 12,
                            "output_dim": 1024}


def _tiny_vit_pair(dtype=jnp.float32):
    rng = np.random.RandomState(0)
    x = rng.randn(2, DIMS["img"], DIMS["img"], 3).astype(np.float32)
    jm = j_vit.EVAViT(img_size=DIMS["img"], patch_size=16, embed_dim=DIMS["vit_embed"],
                      num_heads=DIMS["vit_heads"], mlp_ratio=8 / 3, pt_hw_seq_len=16,
                      dtype=dtype, **L_VIT)
    flat, params = init_params(jm, jnp.asarray(x))
    pm = load_port(eva_vit.EVAViT(patch_size=16, embed_dim=DIMS["vit_embed"],
                                  num_heads=DIMS["vit_heads"], mlp_ratio=8 / 3, pt_hw_seq_len=16,
                                  **L_VIT), flat, "backbone/net/", "backbone.net.")
    assert {"blocks_0/attn/q_proj/kernel", "blocks_5/mlp/ffn_ln/scale"} <= set(flat)
    assert not any("inner_attn_ln" in k or "w12" in k for k in flat)
    return x, jm, params, pm


def test_tiny_non_clip_vit_matches_ape_tpu_in_f32():
    x, jm, params, pm = _tiny_vit_pair()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tiny_non_clip_vit_in_bf16_rounds_as_ape_tpu():
    """bf16 through six blocks: the port's output as far from JAX's bf16
    output, and from the f32 output, as twice JAX's own bf16 error (its
    distance to the f32 output, about four bf16 steps here)."""
    x, jm, params, pm = _tiny_vit_pair()
    f32 = torch.from_numpy(np.asarray(jm.apply({"params": params}, jnp.asarray(x))))
    jb = jm.clone(dtype=jnp.bfloat16)
    want = torch.from_numpy(np.asarray(
        jb.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)))
    with torch.no_grad():
        got = pm(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jax_err = float((want - f32).abs().max())
    assert bf16_steps(f32, 1) <= jax_err <= bf16_steps(f32, 8)  # bf16 rounds, and not wildly
    assert float((got.float() - want).abs().max()) <= 2 * jax_err
    assert float((got.float() - f32).abs().max()) <= 2 * jax_err


def test_weight_round_trip_over_the_full_size_tree():
    """Every key of the full-size APE-L that JAX instantiates from the ADE20k
    panoptic config survives flax -> port -> flax exactly, and build_ape_l
    takes the state_dict strictly (assigned over a storage-less model)."""
    from ape_tpu.checkpoint.convert import convert_torch_state_dict

    jm = instantiate(LazyConfig.load(ADE.format("")).model)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), jnp.asarray([[256, 256]]),
        jnp.zeros((1, 4, 1024)), jnp.ones((1, 4), bool)))["params"]
    gen = np.random.default_rng(0)
    flat = {k: gen.standard_normal(v.shape, np.float32) for k, v in flatten(shapes).items()}
    assert sum(v.size for v in flat.values()) > 3e8
    assert "backbone/net/blocks_23/attn/q_proj/kernel" in flat
    assert not any("inner_attn_ln" in k for k in flat)
    sd = state_dict_from_jax(flat)
    model = _meta_model()
    model.load_state_dict(sd, strict=True, assign=True)
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    del sd, model
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


_PAIRS = {}


def _pair(vlf):
    if vlf not in _PAIRS:
        _PAIRS[vlf] = model_pair(jax_tiny_l(vl_fusion=vlf), torch_tiny_l(vl_fusion=vlf))
    return _PAIRS[vlf]


@pytest.mark.parametrize("vlf,mode", [(False, "text"), (True, "zero"), (True, "text")],
                         ids=["plain", "vlf_name", "vlf_phrase"])
def test_tiny_l_matches_ape_tpu(monkeypatch, vlf, mode):
    """The tiny APE-L (masked, 4-scale) on a padded image; its _vlf_ twin as
    APE serves a name prompt (fused against the zero token, aligned to the
    original text) and a phrase (fused and aligned to the fused text)."""
    import ape_tpu.modeling.ape_deta.transformer as jt

    jm, params, _, pm = _pair(vlf)
    selected = []
    select = jt.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    monkeypatch.setattr(jt, "deta_first_stage_select", recording_select)
    inputs = tiny_inputs(h=200, w=240)
    kw = dict(align_on_fused=mode == "text", fusion_text_mode=mode)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, **kw))(
        params, *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        got = pm.eval()(*(_t(a) for a in inputs), **kw)
    np.testing.assert_array_equal(got["first_stage_indices"].numpy(), selected[-1])
    for key in ("pred_logits", "pred_boxes", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)
    # mask logits: sums over 64 channels of O(1) terms, held to 1e-4 of their
    # largest entry, as tests/test_torch_masks.py holds them
    masks = np.asarray(want["pred_masks"])
    assert np.abs(got["pred_masks"].numpy() - masks).max() <= ATOL * np.abs(masks).max()


def _batch():
    img, sizes, text, valid = tiny_inputs(h=200, w=240)
    side = DIMS["img"] // 4
    targets = {"labels": np.asarray([[0, 3, 0]], np.int32),
               "boxes": np.asarray([[[0.35, 0.4, 0.3, 0.35], [0.6, 0.55, 0.25, 0.4],
                                     [0.5, 0.5, 0.1, 0.1]]], np.float32),
               "valid": np.asarray([[True, True, False]]),
               "masks": np.random.RandomState(11).rand(1, 3, side, side) > 0.7}
    return {"images": img, "image_sizes": sizes, "text_features": text, "text_valid": valid,
            "targets": targets}


@pytest.mark.parametrize("vlf", [False, True], ids=["plain", "vlf"])
def test_tiny_l_train_step_matches_ape_tpu(vlf):
    """One masked step (name prompts, as the recipes' first dataset): the
    loss terms and every parameter's gradient against JAX's, the _vlf_
    twin with its encoder recompute on."""
    jm, params, _, pm = _pair(vlf)
    batch = _batch()
    crit_kw = dict(num_classes=DIMS["num_text"] + 1, num_queries=DIMS["queries"],
                   losses=("class", "boxes", "masks"))
    jcrit = j_criterion.DeformableCriterion(weight_dict=j_criterion.default_weight_dict(),
                                            **crit_kw)
    targets = {k: jnp.asarray(v) for k, v in batch["targets"].items()}

    def jax_loss(p):
        out = jm.apply({"params": p}, *(jnp.asarray(batch[k]) for k in
                                        ("images", "image_sizes", "text_features",
                                         "text_valid")), align_on_fused=False)
        nb = jnp.clip(jnp.sum(targets["valid"].astype(jnp.float32)), 1.0)
        losses = jcrit(jax.random.PRNGKey(0), out, targets, nb, None)
        return jcrit.total(losses), losses

    (total, losses), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    want = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(grads).items()})

    pm = copy.deepcopy(pm).train()
    pm.transformer.encoder.use_act_checkpoint = vlf
    crit = DeformableCriterion(weight_dict=default_weight_dict(), **crit_kw)
    port_batch = {k: _t(v) for k, v in batch.items() if k != "targets"}
    port_batch["targets"] = {**{k: _t(v) for k, v in batch["targets"].items()},
                             "labels": _t(batch["targets"]["labels"]).long()}
    got_total, got_losses, _ = loss_fn(pm, crit, port_batch)
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
    assert got_losses["loss_mask"].item() > 0


TEXT_768 = dict(width=768, heads=12, layers=12, output_dim=1024)


def test_768_wide_text_tower_matches_ape_tpu(rng):
    """The configs' tower shape at narrow widths (12 heads of 8, 3 layers)
    on token ids, end-of-text and per-token features within 1e-4."""
    from ape_tpu.modeling.text import clip_text as j_clip
    from ape_tpu_torch.modeling.text import clip_text

    tower = dict(vocab_size=49408, context_length=77, width=96, heads=12, layers=3, output_dim=64)
    jm = j_clip.CLIPTextTransformer(**tower)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))["params"]
    flat = flatten(jax.tree_util.tree_map(np.asarray, params))
    pm = clip_text.CLIPTextTransformer(**tower)
    pm.load_state_dict(language_state_dict_from_jax(flat), strict=True)
    tokens = np.zeros((3, 77), np.int32)
    for i, n in enumerate((4, 20, 77)):
        tokens[i, :n] = rng.randint(1, 400, n)
        tokens[i, n - 1] = 49407
    want_eot, want_seq = jm.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got_eot, got_seq = pm.eval()(_t(tokens).long())
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), atol=ATOL)
    np.testing.assert_allclose(got_eot.numpy(), np.asarray(want_eot), atol=ATOL)


def test_768_wide_language_weights_round_trip():
    """JAX's tower at the configs' widths: flax -> port -> flax exactly, and
    the port's EVA02CLIP at those widths takes the weights strictly."""
    from ape_tpu.checkpoint.convert import convert_language_state_dict
    from ape_tpu.modeling.text import clip_text as j_clip
    from ape_tpu_torch.modeling.text import EVA02CLIP

    jm = j_clip.CLIPTextTransformer(vocab_size=49408, context_length=77, **TEXT_768)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 77), jnp.int32)))["params"]
    gen = np.random.default_rng(1)
    flat = {k: gen.standard_normal(v.shape, np.float32) for k, v in flatten(shapes).items()}
    assert flat["text_projection"].shape == (768, 1024)
    sd = language_state_dict_from_jax(flat)
    back = convert_language_state_dict({k: v.numpy() for k, v in sd.items()})
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    tower = EVA02CLIP(sd, device="cpu", **TEXT_768)
    assert len(tower.model.transformer.resblocks) == 12
