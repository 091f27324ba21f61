"""The port's whole slice against ape_tpu on the CPU, in f32, plus its
boundaries: the weight round trip through both converters, the import
closure (no JAX, flax or PIL), postprocessing, the APE wrapper and the
predictor's resize.

The slice runs at the parity-harness dims (img 256, 2 + 2 layers, 60
queries) with the protocol pyramid (scales 2, 1, 0.5 and one extra neck
conv). Sum over levels of min(1000, H_l * W_l) is 1344 >= 60 queries, so the
JAX select never falls back to its index-0 pad slots.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.parity_harness import DIMS, FakeLanguage
from tests.torch_parity import (
    flatten,
    jax_tiny_protocol,
    model_pair,
    tiny_inputs,
    torch_tiny_protocol,
)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tiny_pair():
    """ape_tpu and port models at tiny protocol dims with the same weights."""
    return model_pair(jax_tiny_protocol(), torch_tiny_protocol())


@pytest.mark.parametrize("h,w", [(256, 256), (200, 240)])
def test_slice_matches_ape_tpu(tiny_pair, monkeypatch, h, w):
    """Logits, boxes and the first-stage selection of the whole slice, on a
    full and a padded image (non-zero grid corrections)."""
    import ape_tpu.modeling.ape_deta.transformer as jt

    jm, params, _, pm = tiny_pair
    selected = []
    select = jt.deta_first_stage_select

    def recording_select(*a, **k):
        sel = select(*a, **k)
        jax.debug.callback(lambda s: selected.append(np.asarray(s)), sel)
        return sel

    monkeypatch.setattr(jt, "deta_first_stage_select", recording_select)
    inputs = tiny_inputs(h=h, w=w)
    want = jax.jit(jm.apply)({"params": params}, *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        got = pm(*(_t(a) for a in inputs))
    assert got["pred_logits"].shape == (1, DIMS["queries"], DIMS["num_text"] + 1)
    np.testing.assert_array_equal(got["first_stage_indices"].numpy(), selected[-1])
    np.testing.assert_allclose(got["pred_logits"].numpy(), np.asarray(want["pred_logits"]), atol=1e-3)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), np.asarray(want["pred_boxes"]), atol=1e-4)


def test_weight_round_trip_ti_protocol_tree():
    """Every key of the APE-Ti protocol tree survives flax -> port -> flax
    exactly, and the port's build_ape_ti takes the state_dict strictly."""
    from ape_tpu.checkpoint.convert import convert_torch_state_dict
    from ape_tpu.modeling.build import build_ape_ti as j_build
    from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
    from ape_tpu_torch.modeling.build import build_ape_ti

    kw = dict(num_queries=12, mask_on=False, scale_factors=(2.0, 1.0, 0.5))
    jm = j_build(img_size=64, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64, 64]]),
        jnp.zeros((1, 4, 1024)), jnp.ones((1, 4), bool)))["params"]
    rng = np.random.RandomState(0)
    flat = {k: rng.randn(*v.shape).astype(np.float32) for k, v in flatten(shapes).items()}
    sd = state_dict_from_jax(flat)
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                    neck_levels=("p3", "p4", "p5", "p6"))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    build_ape_ti(**kw, device="cpu").load_state_dict(sd, strict=True)


def test_instance_inference_matches(rng):
    from ape_tpu.modeling.ape_deta.postprocess import instance_inference as j_inst
    from ape_tpu_torch.modeling.ape_deta.postprocess import instance_inference

    logits = rng.randn(60, 9).astype(np.float32) - 3.0
    boxes = np.concatenate([rng.rand(60, 2), 0.05 + 0.3 * rng.rand(60, 2)], 1).astype(np.float32)
    size = np.asarray([200, 240], np.int32)
    valid = np.arange(9) < 7
    want = j_inst(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(size), jnp.asarray(valid))
    got = instance_inference(_t(logits), _t(boxes), _t(size), _t(valid))
    for k in ("valid", "classes", "query_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    assert 0 < int(got["valid"].sum()) < 300  # thresholds and NMS both bite


def test_ape_wrapper_matches(tiny_pair):
    """A text prompt, and a dataset vocabulary with a thing/stuff split (the
    instance path sees things only), through both wrappers."""
    from ape_tpu.data.catalog import MetadataCatalog
    from ape_tpu.engine.ape_wrapper import APE as JAPE
    from ape_tpu_torch.engine.ape_wrapper import APE

    jm, params, _, pm = tiny_pair
    meta = MetadataCatalog.get("torch_port_tiny").set(
        thing_classes=["cat", "dog", "car", "bus"], stuff_classes=["sky", "dog", "road"])
    img, sizes, _, _ = tiny_inputs(h=200, w=256)
    feats = np.random.RandomState(5).randn(DIMS["num_text"], DIMS["ldim"]).astype(np.float32)
    inputs = [{"image": img[0], "image_size": sizes[0], "text_prompt": "cat, dog, traffic_light"},
              {"image": img[0], "image_size": sizes[0]}]
    want = JAPE(jm, params, FakeLanguage(feats), dataset_names=[meta.name],
                semantic_on=False)([dict(i) for i in inputs])
    port = APE(pm, FakeLanguage(feats), dataset_metadata=[meta])
    got = port([dict(i) for i in inputs])
    assert got[1]["text_list"] == ["cat", "dog", "car", "bus", "sky", "road"]
    assert port.prompt_type(inputs[0]) == "name"
    assert port.prompt_type({"text_prompt": "a red car, dog"}) == "phrase"
    for g, w in zip(got, want):
        assert g["text_list"] == w["text_list"]
        gi, wi = g["instances"], w["instances"]
        assert len(wi["scores"]) > 0
        np.testing.assert_array_equal(gi["classes"].numpy(), wi["classes"])
        np.testing.assert_allclose(gi["scores"].numpy(), wi["scores"], atol=1e-4)
        np.testing.assert_allclose(gi["boxes"].numpy(), wi["boxes"], atol=1e-2)
    assert int(got[1]["instances"]["classes"].max()) < 4


def test_predictor_resize_matches_pil(rng):
    """Shortest edge to the canvas size, the longest capped, as PIL resizes
    (uint8 rounding may differ by one)."""
    from ape_tpu.data.transforms import resize_shortest_edge as pil_resize
    from ape_tpu_torch.engine.defaults import resize_shortest_edge

    for h, w in ((48, 64), (80, 60), (300, 200)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want, r_want = pil_resize(img, 96, 96)
        got, r = resize_shortest_edge(torch.from_numpy(img), 96, 96)
        assert r == r_want and tuple(got.shape) == want.shape
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_build_refuses_to_fall_back_to_the_cpu(monkeypatch):
    """build_ape_ti() builds on the card by default: with no card and no
    device it raises instead of handing back a CPU model."""
    from ape_tpu_torch.modeling.build import build_ape_ti

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ape_ti(num_queries=12, mask_on=False)
    model = build_ape_ti(num_queries=12, mask_on=False, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_import_closure_and_tiny_serve():
    """In a fresh interpreter that refuses jax, flax, PIL and the JAX
    package (ape_tpu, experiments), the port imports (its training modules,
    the window-MSDA forms, both races and the two probe tools, the ResNet,
    the R50 builders and the Hungarian matcher too), reads
    its own copy of the LVIS counts for the federated loss, builds,
    and serves a non-square image through the predictor. The interpreter
    runs torch on two threads, so that beside the suite's other workers it
    does not take every core; its time limit catches a hang, not load."""
    code = textwrap.dedent("""
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL", "ape_tpu", "experiments"):
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        import numpy as np, torch
        torch.set_num_threads(2)
        import ape_tpu_torch
        from ape_tpu_torch.ops import msda_window_forms
        from ape_tpu_torch.tools import backbone_fix_probe, msda_bwd_race, msda_race, pair_probe
        from ape_tpu_torch.ops import msda_pair_probe
        from ape_tpu_torch.checkpoint import state_dict_from_jax
        from ape_tpu_torch.engine import APE, DefaultPredictor
        from ape_tpu_torch.ops import _build
        from ape_tpu_torch.modeling.build import build_ape_ti
        from ape_tpu_torch.engine.optimizer import build_optimizer
        from ape_tpu_torch.engine.train_step import make_train_step
        from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion
        from ape_tpu_torch.modeling.ape_deta.matchers import stage1_assign, stage2_assign
        from ape_tpu_torch.modeling.ape_deta.matchers import auction_assign, hungarian_match
        from ape_tpu_torch.modeling.backbone.resnet import ResNet
        from ape_tpu_torch.modeling.build import build_ape_r50, build_deformable_detr_r50
        from ape_tpu_torch.data.datasets.metadata import fed_loss_cls_weights
        assert len(fed_loss_cls_weights("lvis_v1_train")) == 1203
        torch.manual_seed(0)
        model = build_ape_ti(num_queries=60, embed_dim_language=32,
                             mask_on=False, scale_factors=(2.0, 1.0, 0.5),
                             device="cpu").eval()
        class Lang:
            def forward_text(self, texts, cache=False):
                return np.random.RandomState(0).randn(len(texts), 32).astype(np.float32)
        pred = DefaultPredictor(APE(model, Lang()), image_size=256)
        img = np.random.RandomState(1).randint(0, 256, (120, 160, 3)).astype(np.uint8)
        out = pred(img, "cat, dog, traffic light")
        assert out["text_list"] == ["cat", "dog", "traffic light"]
        assert out["instances"]["boxes"].shape[-1] == 4
        assert set(_build.LAUNCHES.values()) == {0}
        print("ok", len(out["instances"]["scores"]))
    """)
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
