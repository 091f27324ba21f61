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
    """No card and no device: it raises (the port's device rule), and other
    language towers than EVA-CLIP wait for their wrappers. More than one
    process and FSDP are no longer refused: ``--num-gpus 2`` runs two gloo
    ranks on the CPU under DDP and, with ``train.fsdp=2``, under FSDP2
    (tests/test_torch_parallel.py holds their steps)."""
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
    from ape_tpu_torch.config import LazyConfig

    cfg = LazyConfig.load(tiny)
    LazyConfig.apply_overrides(cfg, ["language.kind=bert"])
    with pytest.raises(NotImplementedError, match="bert"):
        train_net.build_language(cfg, "cpu")


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
