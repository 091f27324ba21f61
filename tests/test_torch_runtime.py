"""The port's runtime against JAX's: the text router, the event storage and
its JSON writer, the tolerant checkpoint loader both ways (a reference-named
``.pth`` with a resized position table and patch kernel into both; the
port's own checkpoint into JAX's loader), the checkpointer and the trainer's
guards, and on the CPU a run of 4 steps against 2 + resume + 2 through
``train_net.main``: the same parameters bit for bit."""

import copy
import json
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ape_tpu.checkpoint.convert import load_params_tolerant
from ape_tpu.config import ConfigDict as JConfigDict
from ape_tpu.config import LazyConfig as JLazyConfig
from ape_tpu.config import instantiate as j_instantiate
from ape_tpu.engine.text_router import TextRouter as JTextRouter
from ape_tpu.utils import events as j_events
from ape_tpu_torch.checkpoint.checkpointer import Checkpointer, PeriodicCheckpointer
from ape_tpu_torch.checkpoint.convert import load_checkpoint_tolerant, state_dict_from_jax
from ape_tpu_torch.config import LazyConfig
from ape_tpu_torch.data.catalog import MetadataCatalog
from ape_tpu_torch.engine.text_router import TextRouter
from ape_tpu_torch.engine.trainer import Trainer
from ape_tpu_torch.model_zoo import build_model
from ape_tpu_torch.utils import events
from tests.parity_harness import FakeLanguage
from tests.test_text_router import _batch
from tests.torch_config_tree import ROOT
from tests.torch_parity import flatten, init_params, load_port

TINY = ROOT / "configs" / "tests" / "ape_deta_tiny.py"


# --- text router ---------------------------------------------------------------

def _route(router_cls, prompt, batches, **kw):
    r = router_cls(num_text=8, text_dim=16, dataset_prompts=[prompt], seed=3, **kw)
    return [r(copy.deepcopy(b)) for b in batches], r.bank


@pytest.mark.parametrize("prompt", ["phrase", "expression", "name"])
def test_text_router_equals_jax(prompt):
    """Features, valid masks, relabelled targets and the bank over three
    batches (the bank carried), without a tower (the SHA-1 hash draw) and,
    for names, with one."""
    batches = [_batch([["a cat", "a dog"], ["a bird"]], [2, 1]),
               _batch([["a cat"], ["", "the tall tree"]], [1, 2]),
               _batch([["a red car", "a cat", "x"]], [3])]
    kws = [{}] if prompt != "expression" else [{}, {"expression_cumulative_gt_class": False}]
    for kw in kws:
        got, bank = _route(TextRouter, prompt, batches, **kw)
        want, jbank = _route(JTextRouter, prompt, batches, **kw)
        np.testing.assert_array_equal(bank, jbank)
        for g, w in zip(got, want):
            for k in ("text_features", "text_valid", "class_valid"):
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g["targets"]["labels"], w["targets"]["labels"])
    if prompt == "name":
        MetadataCatalog.get("router_test").set(thing_classes=["cat", "dog", "bird"])
        from ape_tpu.data.catalog import MetadataCatalog as JMetadataCatalog

        JMetadataCatalog.get("router_test").set(thing_classes=["cat", "dog", "bird"])
        lang = FakeLanguage(np.random.RandomState(0).randn(8, 16))
        b = _batch([["a"]], [1])
        del b["phrases"]
        kw = dict(model_language=lang, num_text=8, text_dim=16, dataset_names=[["router_test"]])
        g = TextRouter(**kw)(copy.deepcopy(b))
        w = JTextRouter(**kw)(copy.deepcopy(b))
        np.testing.assert_array_equal(g["text_features"], w["text_features"])
        np.testing.assert_array_equal(g["text_valid"], w["text_valid"])


# --- events ----------------------------------------------------------------------

def test_event_storage_and_json_writer_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    port, jax_ = events.EventStorage(), j_events.EventStorage()
    pw = events.JSONWriter(str(tmp_path / "p" / "metrics.json"))
    jw = j_events.JSONWriter(str(tmp_path / "j" / "metrics.json"))
    for it in range(25):
        for s in (port, jax_):
            s.put_scalars(total_loss=float(rng.rand()) if s is port else last, lr=1e-4 * it)
            if s is port:
                last = s.latest()["total_loss"]
        pw.write(port)
        jw.write(jax_)
        port.step()
        jax_.step()
    pw.close()
    jw.close()
    assert (tmp_path / "p" / "metrics.json").read_text() == \
        (tmp_path / "j" / "metrics.json").read_text()
    for k, h in jax_.histories().items():
        ph = port.histories()[k]
        assert (ph.median(), ph.avg(), ph.global_avg()) == (h.median(), h.avg(), h.global_avg())
    events.CommonMetricPrinter(25, 5).write(port)  # a log line, no error
    tb = events.TensorboardWriter(str(tmp_path / "tb"))
    tb.write(port)
    tb.close()


# --- checkpoints -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    """JAX's tiny model with seeded params and the port's from build_model
    with the same weights."""
    jm = j_instantiate(JConfigDict(model=JLazyConfig.load(str(TINY)).model))["model"]
    args = (jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64, 64]]), jnp.zeros((1, 4, 256)),
            jnp.ones((1, 4), bool))
    flat, tree = init_params(jm, *args, heads=2)
    pm = load_port(build_model(LazyConfig.load(str(TINY)), device="cpu"), flat, "", "")
    return tree, pm


def test_tolerant_load_equals_jax(tiny_pair, tmp_path):
    """A reference-named .pth whose position table has a 3 x 3 grid and
    whose patch kernel is 14 x 14 (both resized bicubically to the model's),
    one key missing and one of the wrong shape: the port's model and JAX's
    tree load the same values, leaf for leaf."""
    tree, pm = tiny_pair
    rng = np.random.RandomState(1)
    sd = {k: rng.randn(*v.shape).astype(np.float32) for k, v in pm.state_dict().items()}
    c = sd["backbone.net.pos_embed"].shape[-1]
    sd["backbone.net.pos_embed"] = rng.randn(1, 10, c).astype(np.float32)
    o, i = sd["backbone.net.patch_embed.proj.weight"].shape[:2]
    sd["backbone.net.patch_embed.proj.weight"] = rng.randn(o, i, 14, 14).astype(np.float32)
    missing = "transformer.level_embeds"
    del sd[missing]
    sd["transformer.enc_output.bias"] = rng.randn(3).astype(np.float32)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tmp_path / "ref.pth")

    want = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(
        load_params_tolerant(str(tmp_path / "ref.pth"), tree)).items()})
    model = copy.deepcopy(pm)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_checkpoint_tolerant(str(tmp_path / "ref.pth"), model)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert missing in report["missing"] and torch.equal(got[missing], before[missing])
    assert [s[0] for s in report["skipped"]] == ["transformer.enc_output.bias"]
    assert not torch.equal(got["backbone.net.pos_embed"], before["backbone.net.pos_embed"])


def test_port_checkpoint_loads_into_jax(tiny_pair, tmp_path):
    """The port's periodic checkpoint (model, optimizer, run state) is a
    file JAX's load_params_tolerant reads: every leaf of its tree loaded."""
    tree, pm = tiny_pair
    model = copy.deepcopy(pm)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    opt = torch.optim.AdamW(model.parameters())
    ckpt = Checkpointer(str(tmp_path), keep=2)
    path = PeriodicCheckpointer(ckpt, 2, 10).step(1, lambda: {
        "model": model.state_dict(), "optimizer": opt.state_dict()})
    loaded = flatten(load_params_tolerant(path, tree))
    want = state_dict_from_jax({k: np.asarray(v) for k, v in loaded.items()})
    own = model.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(v.numpy(), own[k].numpy(), err_msg=k)
    assert ckpt.latest_step() == 2 and ckpt.kept() == ["model_0000002.pth"]


def test_checkpointer_keeps_the_newest(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    periodic = PeriodicCheckpointer(ckpt, 3, 8)
    for it in range(8):
        periodic.step(it, lambda: {"model": {}})
    assert ckpt.kept() == ["model_0000006.pth", "model_final.pth"]
    assert sorted(p.name for p in tmp_path.glob("*.pth")) == ckpt.kept()
    assert (tmp_path / "last_checkpoint").read_text() == "model_final.pth"
    state, it = ckpt.resume_or_load(resume=True)
    assert it == 8 and state["iteration"] == 8
    assert Checkpointer(str(tmp_path / "empty")).resume_or_load(resume=True) == (None, 0)


def test_trainer_guards_a_non_finite_loss(tmp_path):
    def step(batch, generator):
        return {"total_loss": torch.tensor(float("nan"))}

    class Loader:
        def __iter__(self):
            while True:
                yield {"images": np.zeros((1, 4, 4, 3), np.float32),
                       "targets": {"valid": np.ones((1, 2), bool)}}

    trainer = Trainer(lambda ds: step, [Loader()], "cpu", max_iter=3,
                      output_dir=str(tmp_path))
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train()


# --- 4 steps against 2 + resume + 2 ---------------------------------------------------

CONFIG = textwrap.dedent("""
    from ape_tpu.config import L, LazyConfig
    from ape_tpu.data.datasets.coco import register_coco_instances
    from ape_tpu.data.mapper import DatasetMapperDETR
    from ape_tpu.data.catalog import DatasetCatalog

    _base = LazyConfig.load({tiny!r})
    model = _base.model
    criterion = _base.criterion
    optimizer = _base.optimizer
    train = _base.train
    train.fast_dev_run.enabled = False
    for _n, _s in (({train_name!r}, "train"), ({val_name!r}, "val")):
        if _n not in DatasetCatalog:
            register_coco_instances(_n, {{}}, {root!r} + f"/{{_s}}.json", {root!r} + f"/{{_s}}")
    dataloader = dict(
        train=dict(dataset_names=[{train_name!r}], batch_size=2, sampler="TrainingSampler",
                   mapper=L(DatasetMapperDETR)(is_train=True, image_size=64, max_gt=6,
                                               mask_size=16)),
        tests=[dict(dataset_name={val_name!r}, evaluator_type="coco",
                    mapper=L(DatasetMapperDETR)(is_train=False, image_size=64))],
    )
""")


def write_tiny_setup(root, name: str):
    """A tiny COCO-format PNG dataset (train and val; 5 categories, within
    the tiny model's 8 text slots) and a config of the tiny model that
    registers and reads it under ``{name}_train`` and ``{name}_val``."""
    from tests.test_torch_data import write_dataset

    for split, seed in (("train", 0), ("val", 1)):
        js, img = write_dataset(root / split, n=5, seed=seed)
        (root / f"{split}.json").write_text(open(js).read().replace('"file_name": "',
                                                                    '"file_name": "img/'))
    cfg = root / "tiny_coco.py"
    cfg.write_text(CONFIG.format(tiny=str(TINY), root=str(root), train_name=f"{name}_train",
                                 val_name=f"{name}_val"))
    return str(cfg)


def test_train_resume_is_bit_exact(tmp_path):
    """4 steps, against 2 steps then --resume for 2 more: the final model,
    AdamW state and scheduler equal bit for bit (the generator, the
    loader's position and the mapper's draws restored)."""
    from ape_tpu_torch.tools import train_net

    cfg = write_tiny_setup(tmp_path, "runtime_resume")
    common = ["--config-file", cfg, "train.checkpoint_period=100", "train.log_period=1",
              "train.eval_period=0"]
    train_net.main(common + [f"train.output_dir={tmp_path / 'a'}", "train.max_iter=4"],
                   device="cpu")
    train_net.main(common + [f"train.output_dir={tmp_path / 'b'}", "train.max_iter=2"],
                   device="cpu")
    summary = train_net.main(["--resume"] + common + [f"train.output_dir={tmp_path / 'b'}",
                                                      "train.max_iter=4"], device="cpu")
    assert summary["start_iter"] == 2
    a = torch.load(tmp_path / "a" / "model_final.pth", weights_only=False)
    b = torch.load(tmp_path / "b" / "model_final.pth", weights_only=False)
    assert a["iteration"] == b["iteration"] == 4
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, s in a["optimizer"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[m], b["optimizer"]["state"][i][m])
    assert a["scheduler"] == b["scheduler"]
    np.testing.assert_array_equal(a["text_bank"], b["text_bank"])
    rows = [json.loads(line) for line in open(tmp_path / "a" / "metrics.json")]
    rows_b = [json.loads(line) for line in open(tmp_path / "b" / "metrics.json")]
    assert [r["total_loss"] for r in rows] == [r["total_loss"] for r in rows_b]
