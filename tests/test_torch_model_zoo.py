"""``model_zoo.build_model`` and ``build_criterion`` against the models and
criteria JAX instantiates from the same config files.

* The two tiny configs (``configs/tests/``), with JAX's init carried across
  by ``state_dict_from_jax``, give JAX's forward in f32.
* Every distinct model tree of ``configs/`` (a config that defines its
  model, the backbone filled in) builds on the meta device; the trees fall
  into groups that differ only in values that shape no parameter; each
  tree, its ViT cut to a one-block stand-in and its encoder and decoder to
  2 layers, has the parameter names and shapes of ``jax.eval_shape`` of
  JAX's cut alike for its group's representative (through
  ``state_dict_from_jax``'s names). The full-size ViT trees are held to
  JAX's in ``tests/test_torch_vit_configs.py``: each config's backbone here
  builds the parameters of its ``VIT_TREES`` entry. The groups are split
  between this file and ``tests/test_torch_model_zoo_trees.py``.
* No config is refused: ``REFUSED`` is empty.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.config import ConfigDict as JConfigDict
from ape_tpu.config import LazyConfig as JLazyConfig
from ape_tpu.config import instantiate as j_instantiate
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.config import LazyConfig
from ape_tpu_torch.model_zoo import build_criterion, build_model, get_config_file
from ape_tpu_torch.model_zoo.model_zoo import _resolved
from tests.torch_config_tree import CONFIGS, ROOT, canonical
from tests.torch_parity import flatten, init_params, load_port

# values that shape no parameter: trees that differ only in them share a group
VALUE_ONLY = {"use_act_checkpoint", "vl_init_values", "window_radius", "two_stage_num_proposals",
              "pre_nms_topk", "nms_thresh_enc", "assign_first_stage", "look_forward_twice",
              "num_queries", "num_classes", "drop_path_rate", "mask_in_feature",
              "mask_encode_level"}
# the one-block ViT (JAX's defaults otherwise) that stands in for a group's
# backbone net
STAND_IN = dict(depth=1, embed_dim=64, num_heads=1, img_size=128, window_block_indexes=(),
                pretrain_img_size=32, use_rel_pos=False)
REFUSED = {}  # config file -> why build_model refuses it: none


def _strip(node):
    if isinstance(node, dict):
        return {k: _strip(v) for k, v in node.items() if k not in VALUE_ONLY}
    if isinstance(node, list):
        return [_strip(v) for v in node]
    return node


def _model_configs():
    """{config file: its resolved model node} over the configs that define a
    whole model (not the base files whose backbone their users fill)."""
    out = {}
    for f in CONFIGS:
        cfg = LazyConfig.load(str(ROOT / f))
        if "model" in cfg:
            m = _resolved(cfg)["model"]
            if m.get("backbone", True) is not None:
                out[f] = cfg
    return out


def _groups():
    """[(representative file, [files])] of the shape groups, in a fixed
    order, a file for each distinct model tree of the group."""
    groups = {}
    for f, cfg in _model_configs().items():
        m = canonical(_resolved(cfg)["model"])
        tree = json.dumps(m, sort_keys=True)
        if isinstance(m.get("backbone"), dict) and "net" in m["backbone"]:
            m["backbone"] = dict(m["backbone"], net="<net>")
        groups.setdefault(json.dumps(_strip(m), sort_keys=True), {}).setdefault(tree, f)
    return sorted((min(trees.values()), sorted(trees.values())) for trees in groups.values())


GROUPS = _groups()
HALF = (len(GROUPS) + 1) // 2


def _stand_in(cfg):
    """The config's model with its ViT cut to STAND_IN and its encoder and
    decoder to 2 layers each (a copy): a layer's names and shapes are its
    neighbours' but for the index."""
    cfg = cfg.clone()
    tr = cfg.model.get("transformer")
    if isinstance(tr, dict):
        tr.encoder["num_layers"] = tr.decoder["num_layers"] = 2
    net = cfg.model.get("backbone", {}).get("net") if isinstance(cfg.model.get("backbone"), dict) \
        else None
    if net is not None:
        for k in [k for k in net if k != "_target_"]:
            del net[k]
        net.update(STAND_IN)
    elif "build_ape_ti" in str(cfg.model["_target_"]):
        cfg.model["img_size"] = 128
    return cfg


def _jax_shapes(path: str, img: int = 128):
    cfg = JLazyConfig.load(str(ROOT / path))
    cfg = _stand_in(cfg)
    jm = j_instantiate(JConfigDict(model=cfg.model))["model"]
    ldim = int(_resolved(LazyConfig.load(str(ROOT / path)))["model"].get("embed_dim_language",
                                                                         1024))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), jnp.asarray([[img, img]]),
        jnp.zeros((1, 4, ldim)), jnp.ones((1, 4), bool)))["params"]
    flat = {k: np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), v.shape, (0,) * len(v.shape))
            for k, v in flatten(shapes).items()}
    return {k: tuple(v.shape) for k, v in state_dict_from_jax(flat).items()}


def _port_shapes(cfg) -> dict:
    return {k: tuple(v.shape) for k, v in build_model(cfg, device="meta").state_dict().items()}


def check_groups(groups):
    """Each group's representative, its ViT cut to the stand-in, has JAX's
    names and shapes; every member so cut has the representative's (their
    full ViTs are ``test_vit_backbones_are_vit_trees``')."""
    for rep, files in groups:
        want = _jax_shapes(rep)
        for f in files:
            assert _port_shapes(_stand_in(LazyConfig.load(str(ROOT / f)))) == want, (rep, f)


def test_model_trees_counted_and_none_is_refused():
    configs = _model_configs()
    assert len(configs) > 250 and REFUSED == {}
    distinct = {json.dumps(canonical(_resolved(c)["model"]), sort_keys=True) for c in
                configs.values()}
    assert len(distinct) == sum(len(fs) for _, fs in GROUPS) >= 80 and len(GROUPS) >= 20


def build_every_tree(groups):
    """Each distinct tree of the groups builds at full size on the meta device."""
    for _, files in groups:
        for f in files:
            build_model(LazyConfig.load(str(ROOT / f)), device="meta")


def test_shape_groups_first_half():
    check_groups(GROUPS[:HALF])


def test_vit_backbones_are_vit_trees():
    """Each config's ViT backbone (the full one; ``configs/tests/`` holds a
    tiny tree of its own) builds the parameters of the VIT_TREES entry whose
    arguments JAX instantiates from it, on the config's pyramid."""
    from ape_tpu_torch.modeling.build import build_backbone_vit
    from tests.test_torch_vit_configs import _fields, _jax_backbone, _tree_of

    seen = {}
    for f, cfg in _model_configs().items():
        node = cfg.model.get("backbone")
        if not isinstance(node, dict) or "net" not in node or f.startswith("configs/tests/"):
            continue
        key = json.dumps(canonical(node), sort_keys=True)
        if key in seen:
            continue
        jcfg = JLazyConfig.load(str(ROOT / f))
        trees = _tree_of(_fields(_jax_backbone(jcfg.model.backbone).net))
        assert len(trees) == 1, f
        scales = tuple(node.get("scale_factors", (4.0, 2.0, 1.0, 0.5)))
        with torch.device("meta"):
            want = {k: tuple(v.shape) for k, v in
                    build_backbone_vit(trees[0], scales).state_dict().items()}
        got = build_model(cfg, device="meta").backbone
        seen[key] = trees[0]
        assert {k: tuple(v.shape) for k, v in got.state_dict().items()} == want, f
    assert len(seen) >= 10


@pytest.mark.parametrize("name,img", [("ape_deta_tiny.py", 64), ("ape_deta_tiny_r50.py", 256)])
def test_tiny_configs_forward_equals_jax(name, img):
    """JAX's model of the tiny config with seeded weights, and the port's
    from build_model with the same weights (strict), give the same
    logits (1e-3), boxes (1e-4) and first-stage selection in f32 (the R50
    tree at 256^2: at 64^2 its extras are 1x1 maps whose GroupNorm of two
    values amplifies f32 rounding)."""
    path = ROOT / "configs" / "tests" / name
    jm = j_instantiate(JConfigDict(model=JLazyConfig.load(str(path)).model))["model"]
    rng = np.random.RandomState(0)
    image = rng.randn(1, img, img, 3).astype(np.float32)
    sizes = np.asarray([[img, img - 8]], np.int32)
    text = rng.randn(1, 8, 256).astype(np.float32)
    valid = np.arange(8)[None] < 7
    flat, tree = init_params(jm, jnp.asarray(image), jnp.asarray(sizes), jnp.asarray(text),
                             jnp.asarray(valid), heads=2)
    pm = load_port(build_model(LazyConfig.load(str(path)), device="cpu"), flat, "", "")
    want = jax.jit(jm.apply)({"params": tree}, image, sizes, text, valid)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in (image, sizes, text, valid)))
    np.testing.assert_allclose(got["pred_logits"].numpy(), np.asarray(want["pred_logits"]),
                               atol=1e-3)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]),
                               atol=1e-4)
    if "pred_masks" in want:
        np.testing.assert_allclose(got["pred_masks"].numpy(), np.asarray(want["pred_masks"]),
                                   atol=1e-3)


@pytest.fixture(scope="module")
def tiny_vjp():
    """JAX's model of ``ape_deta_tiny.py`` (``look_forward_twice`` on, its
    default) with seeded weights, and the gradient of every parameter for
    a seeded cotangent on every layer's boxes and logits and the masks:
    (flat weights, inputs, cotangents, gradients under the port's names)."""
    path = ROOT / "configs" / "tests" / "ape_deta_tiny.py"
    jm = j_instantiate(JConfigDict(model=JLazyConfig.load(str(path)).model))["model"]
    assert jm.transformer.decoder.look_forward_twice
    rng = np.random.RandomState(1)
    inputs = (rng.randn(1, 64, 64, 3).astype(np.float32), np.asarray([[64, 56]], np.int32),
              rng.randn(1, 8, 256).astype(np.float32), np.arange(8)[None] < 7)
    flat, tree = init_params(jm, *(jnp.asarray(a) for a in inputs), heads=2)
    outs = jax.jit(jm.apply)({"params": tree}, *inputs)
    cot = {k: rng.randn(*np.shape(v)).astype(np.float32) for k, v in _vjp_outputs(outs).items()}

    def loss(p):
        out = _vjp_outputs(jm.apply({"params": p}, *inputs))
        return sum(jnp.sum(out[k] * cot[k]) for k in cot)

    grads = jax.jit(jax.grad(loss))(tree)
    return flat, inputs, cot, state_dict_from_jax({k: np.asarray(v) for k, v in
                                                   flatten(grads).items()})


def _vjp_outputs(out):
    """Every decoder layer's boxes and logits, and the masks."""
    outs = {"boxes": out["pred_boxes"], "logits": out["pred_logits"], "masks": out["pred_masks"]}
    for i, aux in enumerate(out["aux_outputs"]):
        outs[f"boxes{i}"], outs[f"logits{i}"] = aux["pred_boxes"], aux["pred_logits"]
    return outs


@pytest.mark.parametrize("look_forward_twice", [True, False])
def test_tiny_config_gradients_equal_jax(tiny_vjp, look_forward_twice):
    """The tiny config's model from build_model, JAX's weights loaded,
    gives JAX's gradient of every parameter for the same cotangents (the
    whole-step tolerance of ``tests/test_torch_train.py``). The config
    turns ``look_forward_twice`` on; turned off, the forward is the same
    but a layer's boxes no longer reach the previous layer's box head: the
    gradients of those heads, and of what lies before them, leave JAX's,
    while the last decoder layer's and its heads' stay."""
    from tests.test_torch_train import _grad_mismatches

    flat, inputs, cot, want = tiny_vjp
    pm = load_port(build_model(LazyConfig.load(str(ROOT / "configs/tests/ape_deta_tiny.py")),
                   device="cpu"), flat, "", "").train()
    assert pm.transformer.decoder.look_forward_twice
    pm.transformer.decoder.look_forward_twice = look_forward_twice
    out = _vjp_outputs(pm(*(torch.from_numpy(a) for a in inputs)))
    sum((out[k] * torch.from_numpy(c)).sum() for k, c in cot.items()).backward()
    bad = _grad_mismatches(pm, want)
    if look_forward_twice:
        assert not bad, sorted(bad)
    else:
        last = len(pm.transformer.decoder.layers) - 1
        heads = {f"transformer.decoder.bbox_embed.{i}.layers.{j}.{w}" for i in range(last)
                 for j in range(3) for w in ("weight", "bias")}
        assert heads <= set(bad), sorted(heads - set(bad))
        after = (f"transformer.decoder.layers.{last}.", f"transformer.decoder.bbox_embed.{last}.",
                 f"class_embed.{last}.")
        assert not [n for n in bad if n.startswith(after)]
        assert any(n.startswith(after) for n, _ in pm.named_parameters())


def _jax_criterion(path):
    cfg = JLazyConfig.load(str(ROOT / path))
    return j_instantiate(JConfigDict(model=cfg.model, c=cfg.criterion))["c"]


def test_criterion_from_config_equals_jax():
    """build_criterion reads JAX's fields (the fed loss's weights
    instantiated) into the port's criterion."""
    cfg = LazyConfig.load(str(ROOT / "configs/tests/ape_deta_tiny.py"))
    crit = build_criterion(cfg)
    jc = _jax_criterion("configs/tests/ape_deta_tiny.py")
    for k in ("num_classes", "alpha", "gamma", "num_queries", "use_stage2", "stage2_iou_thresh",
              "stage2_max_k", "stage1_t_low", "stage1_t_high", "stage1_max_k", "use_fed_loss"):
        assert getattr(crit, k) == getattr(jc, k), k
    assert crit.weight_dict == dict(jc.weight_dict) and tuple(crit.losses) == tuple(jc.losses)
    lvis = LazyConfig.load(str(ROOT / "configs/LVIS_InstanceSegmentation/ape_deta/"
                                      "ape_deta_vitl_eva02_lsj1024_cp_24ep.py"))
    crit = build_criterion(lvis)
    jl = _jax_criterion("configs/LVIS_InstanceSegmentation/ape_deta/"
                        "ape_deta_vitl_eva02_lsj1024_cp_24ep.py")
    assert crit.use_fed_loss and jl.use_fed_loss
    np.testing.assert_array_equal(crit.fed_loss_cls_weights.numpy(),
                                  np.asarray(jl.fed_loss_cls_weights, np.float32))


def test_zoo_names_and_device_rule(monkeypatch):
    assert get_config_file("APE-Ti").endswith("ape_deta_vitt_eva02_vlf_lsj1024_cp_16x4_1080k_mdl.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(LazyConfig.load(str(ROOT / "configs/tests/ape_deta_tiny.py")))
