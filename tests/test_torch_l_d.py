"""The port's APE-L_D serving path against ape_tpu on the CPU, in f32 (the
fusion layer also in bf16), on the same seeded weights carried across by
``state_dict_from_jax``:

* the EVA-02-CLIP blocks (subln attention with the inner LayerNorm, SwiGLU
  unpacked with ``ffn_ln``), at a narrow width and at L_D's (1024-d, 16
  heads, hidden 2730, a window of 32 with padding), and the shared helpers
  at L_D's sizes (RoPE at window 32 and at 64 with pt_hw_seq_len 16, the
  21 -> 64 bicubic resize, window_partition at 32): atol 1e-4;
* the fusion block with padded text, both outputs, also with logits past
  the +-50000 clamps: atol 1e-4; and in bf16 against JAX's in bf16, with
  small logits, logits of a few hundred and logits past the clamps: one
  bf16 step of each output's largest magnitude;
* the encoder with fusion, memory and text: atol 1e-4;
* a tiny L_D (tests/torch_parity.L_D_VIT, L_D_FUSION) under every fusion
  text mode, with align_on_fused on and off: logits 1e-3, boxes 1e-4, the
  text the heads aligned to 1e-4;
* the APE wrapper's routing tables (prompt type, fusion mode, box budget)
  and its requests on the tiny L_D;
* the weight round trip over the L_D tree, and the device rule of build_ape_l_d.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.layers import fuse as j_fuse
from ape_tpu.modeling.backbone import eva_vit as j_vit
from ape_tpu.modeling.backbone import vit_utils as j_utils
from ape_tpu_torch.layers import fuse
from ape_tpu_torch.modeling.backbone import eva_vit, vit_utils
from tests.parity_harness import DIMS, FakeLanguage
from tests.torch_parity import (
    flatten,
    init_params,
    jax_tiny_l_d,
    load_port,
    model_pair,
    tiny_inputs,
    torch_tiny_l_d,
    unflatten,
)

ATOL = 1e-4
MODES = ("text", "zero", "learnable", "none")


def _t(x):
    return torch.from_numpy(np.array(x))


def test_vit_utils_at_l_d_sizes(rng):
    """RoPE at window 32 and at the 64^2 global grid, pretrained at 16; the
    position table pretrained at 336 (21^2 + 1 rows) resized to 64^2;
    window_partition at 32."""
    for seq in (32, 64):
        cos, sin = vit_utils.rope_2d_table(32, seq, 16)
        jcos, jsin = j_utils.rope_2d_table(32, seq, 16)
        np.testing.assert_array_equal(cos, jcos)
        np.testing.assert_array_equal(sin, jsin)
    np.testing.assert_array_equal(vit_utils.bicubic_resize_matrix(21, 64),
                                  j_utils.bicubic_resize_matrix(21, 64))
    pos = rng.randn(1, 21 * 21 + 1, 16).astype(np.float32)
    got = vit_utils.resize_abs_pos(_t(pos), True, (64, 64))
    want = j_utils.resize_abs_pos(jnp.asarray(pos), True, (64, 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    x = rng.randn(1, 40, 40, 4).astype(np.float32)
    got, pad_hw = vit_utils.window_partition(_t(x), 32)
    want, want_pad = j_utils.window_partition(jnp.asarray(x), 32)
    assert pad_hw == want_pad == (64, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dim,heads", [(64, 4), (1024, 16)])
def test_subln_attention_with_inner_ln(rng, dim, heads):
    """Separate q/k/v projections without bias, q/v biases, RoPE, and the
    inner LayerNorm before proj, global (plain attention on the CPU)."""
    x = rng.randn(1, 4, 4, dim).astype(np.float32)
    cos, sin = j_utils.rope_2d_table(dim // heads // 2, 4, 16)
    jm = j_vit.Attention(dim=dim, num_heads=heads, subln=True, inner_attn_ln=True)
    flat, params = init_params(jm, jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    assert {"q_proj/kernel", "k_proj/kernel", "v_proj/kernel", "inner_attn_ln/scale"} <= set(flat)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cos),
                               jnp.asarray(sin)))
    pm = load_port(eva_vit.Attention(dim, heads, True, subln=True, inner_attn_ln=True), flat,
                   "backbone/net/blocks_0/attn/", "backbone.net.blocks.0.attn.")
    with torch.no_grad():
        got = pm(_t(x), _t(cos), _t(sin)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("dim,hidden", [(48, 128), (1024, int(1024 * 8 / 3))])
def test_unpacked_swiglu_with_ffn_ln(rng, dim, hidden):
    """w1 and w2 apart, ffn_ln on the hidden layer, then w3; at L_D's hidden
    width 2730, which is not a multiple of 8."""
    x = rng.randn(2, 5, dim).astype(np.float32)
    jm = j_vit.SwiGLU(hidden_dim=hidden, out_dim=dim, packed=False, subln=True)
    flat, params = init_params(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = load_port(eva_vit.SwiGLU(dim, hidden, packed=False, subln=True), flat,
                   "backbone/net/blocks_0/mlp/", "backbone.net.blocks.0.mlp.")
    with torch.no_grad():
        got = pm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_l_d_block_at_full_width_in_a_padded_window(rng):
    """One EVA-02-CLIP-L block (1024-d, 16 heads, hidden 2730) windowed at
    32 on a 20 x 20 grid, which window_partition pads to one window."""
    x = rng.randn(1, 20, 20, 1024).astype(np.float32)
    cos, sin = j_utils.rope_2d_table(32, 32, 16)
    kw = dict(subln=True, inner_attn_ln=True, packed_swiglu=False, swiglu_subln=True)
    jm = j_vit.Block(dim=1024, num_heads=16, mlp_hidden_dim=2730, window_size=32, **kw)
    flat, params = init_params(jm, jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cos),
                               jnp.asarray(sin)))
    pm = load_port(eva_vit.Block(1024, 16, 2730, 32, **kw), flat, "backbone/net/blocks_0/",
                   "backbone.net.blocks.0.")
    with torch.no_grad():
        got = pm(_t(x), _t(cos), _t(sin)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("clamped", [False, True])
def test_bi_attention_block_with_padded_text(rng, clamped):
    """Both outputs of the fusion block, text with invalid slots; with the
    projections scaled so that most logits pass the +-50000 clamps."""
    v = rng.randn(2, 50, 64).astype(np.float32)
    l = rng.randn(2, 9, 32).astype(np.float32)
    valid_v = np.ones((2, 50), bool)
    valid_l = np.arange(9)[None] < np.asarray([[9], [5]])
    jm = j_fuse.BiAttentionBlock(v_dim=64, l_dim=32, embed_dim=64, num_heads=2)
    args = tuple(jnp.asarray(a) for a in (v, l, valid_v, valid_l))
    flat, _ = init_params(jm, *args)
    if clamped:
        flat = {k: w * 300.0 if k in ("attn/v_proj/kernel", "attn/l_proj/kernel") else w
                for k, w in flat.items()}
    want_v, want_l = jm.apply({"params": unflatten(flat)}, *args)
    pm = load_port(fuse.VisionLanguageFusion(64, 32, 64, 2), flat,
                   "transformer/encoder/vl_layers_0/", "transformer.encoder.vl_layers.0.")
    with torch.no_grad():
        got_v, got_l = pm(_t(v), _t(l), _t(valid_l))
        if clamped:  # the clamps bite: the shared logits pass 50000
            b = pm.b_attn
            q = b.attn.v_proj(b.layer_norm_v(_t(v))) * 32**-0.5
            k = b.attn.l_proj(b.layer_norm_l(_t(l)))
            assert float((q[..., :32] @ k[..., :32].transpose(1, 2)).abs().max()) > 5e4
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL)


@pytest.mark.parametrize("logits", ["small", "near_300", "clamped"])
def test_fusion_in_bf16_rounds_as_jax(rng, logits):
    """The fusion layer in bf16 (bf16 vision tokens, f32 text as the model
    passes it, padded text) against JAX's BiAttentionBlock(dtype=bfloat16):
    both outputs within one bf16 step of their largest magnitude. The query
    and key projections are scaled so that the shared logits stay small,
    reach a few hundred (a bf16 step of a logit is then a large step of a
    probability) or pass the +-50000 clamps (where the clamp rounds to
    49920); a slip in the rounding order (the text rounded before its norm,
    the logits kept in f32, a clamp left out) puts the outputs steps apart
    there. Head width 16: the scale 1/4 is exact in bf16, as L_D's 1/16.
    The query and key projections carry no bias: the port's Linear rounds
    the product and bias once, flax's Dense on XLA's CPU the product first,
    and at logits past the clamps one step of a logit (256) decides the
    softmax; the value and output projections keep theirs."""
    from ape_tpu_torch.ops.bounds import bf16_steps

    mult = {"small": 1.0, "near_300": 8.0, "clamped": 300.0}[logits]
    v = rng.randn(2, 50, 64).astype(np.float32)
    l = rng.randn(2, 9, 32).astype(np.float32)
    valid_l = np.arange(9)[None] < np.asarray([[9], [5]])
    jm = j_fuse.BiAttentionBlock(v_dim=64, l_dim=32, embed_dim=64, num_heads=4,
                                 dtype=jnp.bfloat16)
    args = (jnp.asarray(v, jnp.bfloat16), jnp.asarray(l), jnp.ones((2, 50), bool),
            jnp.asarray(valid_l))
    flat, _ = init_params(jm, *args)
    for name in ("v_proj", "l_proj"):
        flat[f"attn/{name}/kernel"] = flat[f"attn/{name}/kernel"] * mult
        flat[f"attn/{name}/bias"] = np.zeros_like(flat[f"attn/{name}/bias"])
    want_v, want_l = jm.apply({"params": unflatten(flat)}, *args)
    pm = load_port(fuse.VisionLanguageFusion(64, 32, 64, 4), flat,
                   "transformer/encoder/vl_layers_0/", "transformer.encoder.vl_layers.0.")
    vb = _t(np.asarray(args[0].astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got_v, got_l = pm(vb, _t(l), _t(valid_l))
        b = pm.b_attn
        q = b.attn.v_proj(b.layer_norm_v(vb)) * 16**-0.5
        k = b.attn.l_proj(b.layer_norm_l(_t(l)).to(torch.bfloat16))
        top = float((q[..., :16] @ k[..., :16].transpose(1, 2)).abs().max())
    assert got_v.dtype == got_l.dtype == torch.bfloat16
    assert {"small": top < 50, "near_300": 100 < top < 1000, "clamped": top > 5e4}[logits], top
    for got, want in ((got_v, want_v), (got_l, want_l)):
        want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
        assert float((got.float() - want).abs().max()) <= bf16_steps(want, 1)


def test_encoder_with_fusion(rng):
    """Two encoder layers, each after a fusion layer: memory and text."""
    from ape_tpu.modeling.ape_deta.transformer import (
        DeformableTransformerEncoder as JEncoder,
        encoder_grid_corrections,
        encoder_reference_points,
    )
    from ape_tpu_torch.modeling.ape_deta.transformer import DeformableTransformerEncoder

    shapes = ((8, 8), (4, 4), (2, 2))
    s = sum(h * w for h, w in shapes)
    kw = dict(embed_dim=32, num_heads=4, feedforward_dim=64, num_layers=2, num_feature_levels=3,
              num_points=2, window_radius=2, vl_fusion=True, vl_embed_dim=64, vl_num_heads=2,
              vl_init_values=1.0 / 6, embed_dim_language=24)
    x, pos = (rng.randn(1, s, 32).astype(np.float32) for _ in range(2))
    valid = np.ones((1, s), bool)
    text = rng.randn(1, 6, 24).astype(np.float32)
    text_valid = np.arange(6)[None] < 4
    ratios = jnp.ones((1, 3, 2))
    refs = np.asarray(encoder_reference_points(shapes, ratios))
    corr = np.asarray(encoder_grid_corrections(shapes, ratios))
    jm = JEncoder(**kw)
    jargs = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(text),
             jnp.asarray(text_valid), shapes, jnp.asarray(refs), jnp.asarray(corr))
    flat, params = init_params(jm, *jargs, heads=4, points=2)
    want_mem, want_text = jm.apply({"params": params}, *jargs)
    pm = load_port(DeformableTransformerEncoder(**kw), flat, "transformer/encoder/",
                   "transformer.encoder.")
    with torch.no_grad():
        got_mem, got_text = pm(_t(x), _t(pos), _t(valid), shapes, _t(refs), _t(corr),
                               _t(text), _t(text_valid))
        # without text the fusion layers are skipped and text stays None
        plain_mem, no_text = pm(_t(x), _t(pos), _t(valid), shapes, _t(refs), _t(corr))
    assert no_text is None
    assert float((plain_mem - got_mem).abs().max()) > 1e-2
    np.testing.assert_allclose(got_mem.numpy(), np.asarray(want_mem), atol=ATOL)
    np.testing.assert_allclose(got_text.numpy(), np.asarray(want_text), atol=ATOL)


@pytest.fixture(scope="module")
def l_d_pair():
    """ape_tpu and port tiny L_D with the same weights, the learned fusion
    token included."""
    return model_pair(jax_tiny_l_d(), torch_tiny_l_d(), fusion_text_mode="learnable")


@pytest.mark.parametrize("align_on_fused", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_tiny_l_d_matches_ape_tpu(l_d_pair, mode, align_on_fused):
    jm, params, _, pm = l_d_pair
    inputs = tiny_inputs()
    want = jm.apply({"params": params}, *(jnp.asarray(a) for a in inputs),
                    align_on_fused=align_on_fused, fusion_text_mode=mode)
    with torch.no_grad():
        got = pm(*(_t(a) for a in inputs), align_on_fused=align_on_fused,
                 fusion_text_mode=mode)
    assert got["pred_logits"].shape == (1, DIMS["queries"], DIMS["num_text"] + 1)
    np.testing.assert_allclose(got["pred_logits"].numpy(), np.asarray(want["pred_logits"]),
                               atol=1e-3)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["text_features"].numpy(), np.asarray(want["text_features"]),
                               atol=ATOL)
    # the heads align to the fused text only under "text" with align_on_fused
    fused = mode == "text" and align_on_fused
    moved = float((got["text_features"] - _t(inputs[2])).abs().max())
    assert (moved > 1e-2) if fused else (moved == 0.0)


def test_fusion_modes_move_the_memory(l_d_pair):
    """Each fusion text gives another encoder memory; "none" none of them."""
    _, _, _, pm = l_d_pair
    inputs = [_t(a) for a in tiny_inputs()]
    with torch.no_grad():
        mems = {m: pm(*inputs, fusion_text_mode=m)["memory"] for m in MODES}
    for i, a in enumerate(MODES):
        for b in MODES[i + 1:]:
            assert float((mems[a] - mems[b]).abs().max()) > 1e-3, (a, b)


def test_wrapper_routing_tables():
    """prompt_type, fusion_mode and the box budget of the port's APE against
    JAX's _prompt_type, _fusion_mode and select_box_nums, per dataset."""
    from ape_tpu.data.catalog import MetadataCatalog
    from ape_tpu.engine.ape_wrapper import APE as JAPE
    from ape_tpu_torch.engine.ape_wrapper import APE

    names = ["torch_l_d_coco", "torch_l_d_lvis+torch_l_d_o365", "torch_l_d_refcoco"]
    metas = [MetadataCatalog.get(n).set(thing_classes=["cat", "dog"]) for n in names]
    prompts = ["name", "name", "expression"]
    inputs = [{}, {"text_prompt": "cat, dog"}, {"text_prompt": "a red car, dog"},
              {"text_prompt": " , bus"}]
    for fusion_type in ("zero", "learnable", "none"):
        kw = dict(dataset_prompts=prompts, select_box_nums_for_evaluation=300,
                  select_box_nums_for_evaluation_list=[100, 900],
                  name_prompt_fusion_text=[False, True], name_prompt_fusion_type=fusion_type)
        want = JAPE(None, None, None, dataset_names=names, **kw)
        got = APE(None, None, dataset_metadata=metas, **kw)
        for dataset in names + ["torch_l_d_o365_val", "unknown"]:
            want.set_eval_dataset(dataset)
            got.set_eval_dataset(dataset)
            assert got.eval_dataset_id == want.eval_dataset_id
            assert got.select_box_nums == want.select_box_nums
            for inp in inputs:
                assert got.prompt_type(inp) == want._prompt_type(inp)
            for ptype in ("name", "phrase", "expression"):
                assert got.fusion_mode(ptype) == want._fusion_mode(ptype), (dataset, ptype)
    assert got.fusion_mode("name") == "none" and got.select_box_nums == 300


def test_wrapper_serves_the_tiny_l_d(l_d_pair):
    """A name prompt (fused against the zero token, aligned to the original
    text) and a phrase prompt (fused and aligned to the fused text) through
    both wrappers."""
    from ape_tpu.engine.ape_wrapper import APE as JAPE
    from ape_tpu_torch.engine.ape_wrapper import APE

    jm, params, _, pm = l_d_pair
    img, sizes, _, _ = tiny_inputs(h=200, w=256)
    feats = np.random.RandomState(5).randn(DIMS["num_text"], DIMS["ldim"]).astype(np.float32)
    inputs = [{"image": img[0], "image_size": sizes[0], "text_prompt": "cat, dog, bus"},
              {"image": img[0], "image_size": sizes[0], "text_prompt": "a red car, a dog"}]
    want = JAPE(jm, params, FakeLanguage(feats), semantic_on=False)([dict(i) for i in inputs])
    port = APE(pm, FakeLanguage(feats))
    got = port([dict(i) for i in inputs])
    assert [g["prompt_type"] for g in got] == ["name", "phrase"]
    for g, w in zip(got, want):
        gi, wi = g["instances"], w["instances"]
        assert len(wi["scores"]) > 0
        np.testing.assert_array_equal(gi["classes"].numpy(), wi["classes"])
        np.testing.assert_allclose(gi["scores"].numpy(), wi["scores"], atol=1e-4)
        np.testing.assert_allclose(gi["boxes"].numpy(), wi["boxes"], atol=1e-2)


def test_weight_round_trip_l_d_tree():
    """Every key of the APE-L_D tree (the masked model, the learned fusion
    token, the backbone cut to 3 blocks: every kind of block key, windowed
    and global) survives flax -> port -> flax exactly, and the port's
    build_ape_l_d takes the state_dict strictly."""
    from ape_tpu.checkpoint.convert import convert_torch_state_dict
    from ape_tpu.modeling.build import build_ape_l_d as j_build
    from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
    from ape_tpu_torch.modeling.build import build_ape_l_d

    jm = j_build(img_size=64, num_queries=12)
    jm = jm.clone(backbone=jm.backbone.clone(net=jm.backbone.net.clone(depth=3)))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64, 64]]),
        jnp.zeros((1, 4, 1024)), jnp.ones((1, 4), bool), fusion_text_mode="learnable"))["params"]
    rng = np.random.RandomState(0)
    flat = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flatten(shapes).items()}
    assert any(k.startswith("transformer/encoder/vl_layers_5/") for k in flat)
    assert "backbone/net/blocks_2/mlp/ffn_ln/scale" in flat
    sd = state_dict_from_jax(flat)
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    build_ape_l_d(num_queries=12, depth=3, name_prompt_fusion_feature=True,
                  device="cpu").load_state_dict(sd, strict=True)


def test_build_ape_l_d_refuses_to_fall_back_to_the_cpu(monkeypatch):
    """build_ape_l_d() builds on the card by default and raises without one."""
    from ape_tpu_torch.modeling.build import build_ape_l_d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ape_l_d()
    model = build_ape_l_d(num_queries=12, depth=3, num_layers=1, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert len(model.transformer.encoder.vl_layers) == 1

