"""``python -m ape_tpu_torch.tools.train_net`` on the tiny config and a tiny
PNG dataset, on the CPU (``train.device=cpu``), in interpreters that refuse
jax, flax, PIL and the JAX package (and torch's TensorBoard writer: the card
machine has no TensorBoard): train, ``--resume``, then ``--eval-only`` on the final checkpoint;
and the entry point's refusals."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.test_torch_runtime import write_tiny_setup
from tests.torch_config_tree import ROOT

RUN = textwrap.dedent("""
    import runpy, sys
    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if (name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL", "ape_tpu", "experiments")
                    or name == "torch.utils.tensorboard"):
                raise ImportError("refused: " + name)
    sys.meta_path.insert(0, Refuse())
    import torch
    torch.set_num_threads(2)
    sys.argv = ["train_net"] + sys.argv[1:]
    runpy.run_module("ape_tpu_torch.tools.train_net", run_name="__main__")
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "PIL", "ape_tpu")]
    assert not leaked, leaked
""")


def _train_net(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", RUN, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stderr


def test_train_resume_eval_without_jax(tmp_path):
    cfg = write_tiny_setup(tmp_path, "train_net_cli")
    out = tmp_path / "out"
    common = ["--config-file", cfg, "train.device=cpu", f"train.output_dir={out}",
              "train.log_period=1", "train.checkpoint_period=1", "train.eval_period=0"]
    log = _train_net(*common, "train.max_iter=2")
    assert "Starting training from iteration 0 to 2" in log
    assert sorted(p.name for p in out.glob("*.pth")) == ["model_0000001.pth", "model_final.pth"]
    log = _train_net("--resume", *common, "train.max_iter=3")
    assert "resumed from iteration 2" in log and "Starting training from iteration 2 to 3" in log
    rows = [json.loads(line) for line in open(out / "metrics.json")]
    assert [r["iteration"] for r in rows] == [0, 1, 2]
    assert all(torch.isfinite(torch.tensor(r["total_loss"])) for r in rows)
    ckpt = torch.load(out / "model_final.pth", weights_only=False)
    assert ckpt["iteration"] == 3
    log = _train_net("--eval-only", "--config-file", cfg, "train.device=cpu",
                     f"train.output_dir={out}", f"train.init_checkpoint={out / 'model_final.pth'}",
                     "language.width=64", "language.heads=2", "language.layers=1")
    line = [ln for ln in log.splitlines() if "train_net_cli_val: {" in ln][-1]
    for key in ("bbox/AP", "bbox/AP50", "segm/AP", "segm/APl", "seconds/device",
                "seconds/postprocess", "seconds/data", "seconds/eval"):
        assert f"'{key}'" in line
    assert "'images': 5" in line


def test_refusals(tmp_path, monkeypatch):
    """No card and no device: it raises (the port's device rule). More than
    one process and FSDP are no longer refused: ``--num-gpus 2`` runs two
    gloo ranks on the CPU under DDP and, with ``train.fsdp=2``, under FSDP2
    (tests/test_torch_parallel.py holds their steps). Nor are the BERT, T5
    and Llama-2 towers (``test_build_language_routes_the_hf_towers``)."""
    from ape_tpu_torch.tools import train_net

    tiny = str(ROOT / "configs" / "tests" / "ape_deta_tiny.py")
    out = f"train.output_dir={tmp_path}"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main(["--config-file", tiny, out])
    cfg = write_tiny_setup(tmp_path, "train_net_ranks")
    for extra, kind in (([], "DDP"), (["train.fsdp=2"], "FSDP2")):
        run = tmp_path / kind
        log = _train_net("--num-gpus", "2", "--config-file", cfg, "train.device=cpu",
                         f"train.output_dir={run}", "train.max_iter=2", "train.eval_period=0",
                         "train.log_period=1", *extra)
        assert f"{kind} over 2 ranks" in log and "Starting training from iteration 0 to 2" in log
        rows = [json.loads(line) for line in open(run / "metrics.json")]
        assert [r["iteration"] for r in rows] == [0, 1]
        assert torch.load(run / "model_final.pth", weights_only=False)["iteration"] == 2


def test_unregistered_dataset_raises_outside_fast_dev_run(tmp_path, monkeypatch):
    """A training dataset the config names but nobody registered raises,
    naming $DETECTRON2_DATASETS; only ``train.fast_dev_run`` trains on the
    synthetic data."""
    from ape_tpu_torch.tools import train_net

    monkeypatch.setenv("DETECTRON2_DATASETS", str(tmp_path / "nowhere"))
    tiny = str(ROOT / "configs" / "tests" / "ape_deta_tiny.py")
    common = ["--config-file", tiny, f"train.output_dir={tmp_path}", "train.max_iter=0"]
    with pytest.raises(ValueError, match=r"\['unregistered_train'\].*\$DETECTRON2_DATASETS.*"
                                         r"nowhere"):
        train_net.main(common + ["train.fast_dev_run.enabled=False",
                                 "dataloader.train.dataset_names=['unregistered_train']"],
                       device="cpu")
    with pytest.raises(ValueError, match="the config names none"):
        train_net.main(common + ["train.fast_dev_run.enabled=False"], device="cpu")


def _tiny_tower_dirs(root):
    """Tiny saved BERT, T5 and Llama-2 directories, each with a tokenizer
    the port reads (T5's a BPE ``tokenizer.json``: the port refuses T5's own
    Unigram)."""
    from tests.test_torch_hf_files import tiny_model, write_bert_vocab
    from tests.test_torch_hf_tokenizers import write_llama_tokenizer

    dirs = {k: root / k for k in ("bert", "t5", "llama2")}
    tiny_model("bert", head=True).save_pretrained(dirs["bert"])
    write_bert_vocab(dirs["bert"])
    tiny_model("t5", head=True).save_pretrained(dirs["t5"])
    write_llama_tokenizer(dirs["t5"])
    tiny_model("llama2", head=True).save_pretrained(dirs["llama2"])
    write_llama_tokenizer(dirs["llama2"])
    return dirs


def test_build_language_routes_the_hf_towers(tmp_path):
    """``language.kind`` bert, t5 and llama2 build the port's towers from a
    tiny saved directory, as JAX's ``build_language`` routes them; an
    unknown kind raises."""
    pytest.importorskip("transformers")
    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.modeling.text import T5, Bert, Llama2
    from ape_tpu_torch.tools import train_net

    tiny = str(ROOT / "configs" / "tests" / "ape_deta_tiny.py")
    dirs = _tiny_tower_dirs(tmp_path)
    for kind, cls in (("bert", Bert), ("t5", T5), ("llama2", Llama2)):
        cfg = LazyConfig.load(tiny)
        LazyConfig.apply_overrides(cfg, [f"language.kind={kind}",
                                         f"language.model_name_or_path={dirs[kind]}"])
        tower = train_net.build_language(cfg, torch.device("cpu"))
        assert type(tower) is cls and tower.device == torch.device("cpu")
        out = tower.forward_text(["a cat", "the dog"])
        feats = out["last_hidden_state_eot"] if isinstance(out, dict) else out
        assert feats.shape[0] == 2 and bool(torch.isfinite(feats).all())
    cfg = LazyConfig.load(tiny)
    LazyConfig.apply_overrides(cfg, ["language.kind=gpt2"])
    with pytest.raises(KeyError, match="gpt2"):
        train_net.build_language(cfg, torch.device("cpu"))


# the five configs JAX's train_net routes to the BERT and Llama-2 towers
HF_CONFIGS = [
    "configs/REFCOCO_VisualGrounding/ape_deta/ape_deta_r50_bert_vlf_12ep.py",
    "configs/COCO_REFCOCO/ape_deta/ape_deta_r50_vlf_bert_36ep.py",
    "configs/LVISCOCOCOCOSTUFF_REFCOCO/ape_deta/ape_deta_r50_vlf_lsj1024_cp_bert_50ep.py",
    "configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/ape_deta/"
    "ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_16x4_1080k_mdl_llama2.py",
    "configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/ape_deta/"
    "ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_16x4x270k_mdl_llama2.py",
]

# a config's recipe (criteria, optimizer, data groups, prompts, tower) on the
# tiny model tree of its backbone family, at 64^2, one image a group
TINY_HF_CONFIG = """
from ape_tpu.config import LazyConfig
_cfg = LazyConfig.load({config!r})
_tiny = LazyConfig.load({tiny!r})
model = _tiny.model
model.transformer.encoder.vl_fusion = True
model.transformer.encoder.vl_embed_dim = 32
model.transformer.encoder.use_act_checkpoint = _cfg.model.transformer.encoder.use_act_checkpoint
model.embed_dim_language = {width}
model.transformer.encoder.embed_dim_language = {width}
optimizer = _cfg.optimizer
dataloader = _cfg.dataloader
for _g in dataloader.train.get("groups", None) or [dataloader.train]:
    _g.batch_size = 1
criterion = _cfg.criterion
if "criterions" in _cfg:
    criterions = _cfg.criterions
language = dict(_cfg.language, model_name_or_path={tower!r})
train = _cfg.train
train.update(image_size=64, iter_size=1, text_dim={width}, text_tower=True)
"""


@pytest.mark.parametrize("config", HF_CONFIGS, ids=lambda c: c.rsplit("/", 1)[-1][:-3])
def test_fast_dev_run_of_the_hf_tower_configs(tmp_path, config):
    """Each config JAX routes to a BERT or Llama-2 tower trains a
    ``fast_dev_run`` on the CPU at tiny size, its prompts encoded by its
    tower read from a tiny saved directory (``train.text_tower``)."""
    pytest.importorskip("transformers")
    from ape_tpu_torch.tools import train_net

    kind = "bert" if "bert" in config else "llama2"
    from tests.test_torch_hf_files import tiny_model, write_bert_vocab
    from tests.test_torch_hf_tokenizers import write_llama_tokenizer

    tower = tmp_path / kind
    tiny_model(kind, head=True).save_pretrained(tower)
    (write_bert_vocab if kind == "bert" else write_llama_tokenizer)(tower)
    tiny = "ape_deta_tiny_r50.py" if "r50" in config else "ape_deta_tiny.py"
    path = tmp_path / "tiny_hf.py"
    path.write_text(TINY_HF_CONFIG.format(config=str(ROOT / config), tower=str(tower),
                                          tiny=str(ROOT / "configs" / "tests" / tiny),
                                          width=16 if kind == "bert" else 32))
    out = tmp_path / "out"
    summary = train_net.main(["--config-file", str(path), f"train.output_dir={out}",
                              "train.fast_dev_run.enabled=True", "train.checkpoint_period=100"],
                             device="cpu")
    assert summary["max_iter"] == 20
    rows = [json.loads(line) for line in open(out / "metrics.json")]
    assert len(rows) == 20 and all(np.isfinite(r["total_loss"]) for r in rows)
    lang = summary["trainer"].text_fn.lang
    assert type(lang).__name__ == {"bert": "Bert", "llama2": "Llama2"}[kind]
    assert lang._cache  # the name vocabulary went through the tower
