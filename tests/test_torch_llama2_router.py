"""The Llama-2 recipe's training prompts on the CPU: the port's
``train_net.build_text_fn`` over
``ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_16x4_1080k_mdl_llama2.py`` (its
nine groups, their prompts and name datasets, the 1280-slot bank) with a
tiny ``Llama2`` tower, against JAX's ``TextRouter`` built as JAX's
``build_text_fn`` builds it with JAX's ``Llama2`` wrapper on the same tiny
``transformers`` model. One run of steps mixes the groups' prompts: a name
batch of Objects365 (365 names encoded once, cached), phrase batches of
Visual Genome (two, so that the second pads with the first's bank) and of
RefCOCO, and a name batch of OpenImages (601 names). Each step's text
features, validity and relabelled targets, and every group's bank after it,
within 1e-5 abs + 1e-5 rel in f32; the labels and masks exact."""

import os

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

from ape_tpu.config import LazyConfig as JLazyConfig  # noqa: E402
from ape_tpu.engine.text_router import TextRouter as JaxRouter  # noqa: E402
from ape_tpu.modeling.text import hf_wrappers as jax_hf  # noqa: E402
from ape_tpu_torch.config import LazyConfig  # noqa: E402
from ape_tpu_torch.modeling.text import hf_wrappers as port_hf  # noqa: E402
from ape_tpu_torch.modeling.text.bpe import HFBPETokenizer  # noqa: E402
from ape_tpu_torch.tools import train_net  # noqa: E402
from tests.test_torch_hf_files import tiny_config, tiny_model  # noqa: E402
from tests.test_torch_hf_tokenizers import write_llama_tokenizer  # noqa: E402
from tests.test_torch_hf_towers import port_tower  # noqa: E402
from tests.torch_config_tree import ROOT  # noqa: E402

CONFIG = ("configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/"
          "ape_deta/ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_16x4_1080k_mdl_llama2.py")
TOL = dict(atol=1e-5, rtol=1e-5)
# the steps: (group, phrases a GT box of each image or None for a name batch,
# valid boxes an image); two images a batch
STEPS = (
    (1, None, (3, 2)),
    (3, (["a red car", "the small dog", "a tree"], ["a cat on a mat", "red car"]), (3, 2)),
    (3, (["the sky", "a man riding a horse"], ["a cat on a mat"]), (2, 1)),
    (5, (["the woman on the left"], ["a photo of the dog", "the man in blue"]), (1, 2)),
    (2, None, (2, 3)),
)
SLOTS = 4  # target slots an image


def _jax_router(cfg, tower):
    """JAX's TextRouter as JAX's tools/train_net.build_text_fn builds it."""
    dl = cfg.dataloader.train
    groups = list(dl.get("groups", None) or [dl])
    prompts = list(cfg.train.get("dataset_prompts", []) or [g.get("prompt", "name")
                                                             for g in groups])
    return JaxRouter(model_language=tower, num_text=int(cfg.train.get("num_text", 80)),
                     text_dim=int(cfg.train.get("text_dim", 1024)), dataset_prompts=prompts,
                     dataset_names=[list(g.get("dataset_names", [])) for g in groups],
                     num_datasets=len(groups), seed=int(cfg.train.get("seed", 0)))


def _batch(group, phrases, n_valid, rng):
    labels = rng.randint(0, 300, (2, SLOTS)).astype(np.int32)
    valid = np.arange(SLOTS)[None] < np.asarray(n_valid)[:, None]
    batch = {"dataset_id": group, "images": np.zeros((2, 8, 8, 3), np.float32),
             "targets": {"labels": labels, "valid": valid}}
    if phrases is not None:
        batch["phrases"] = [list(p) for p in phrases]
    return batch


def test_llama2_recipe_routes_prompts_as_jax(tmp_path):
    import ape_tpu.data.datasets  # noqa: F401  (JAX's builtin metadata)
    import ape_tpu_torch.data.datasets  # noqa: F401  (the port's)

    width = tiny_config("llama2").hidden_size
    tok = write_llama_tokenizer(tmp_path / "tok")
    hf = tiny_model("llama2")
    jax_tower = jax_hf.Llama2(model=hf, tokenizer=transformers.AutoTokenizer.from_pretrained(
        str(tok)))
    port_tower_ = port_hf.Llama2(model=port_tower("llama2", hf),
                                 tokenizer=HFBPETokenizer.from_dir(tok), device="cpu")
    jcfg = JLazyConfig.load(str(ROOT / CONFIG))
    cfg = LazyConfig.load(str(ROOT / CONFIG))
    assert cfg.language["kind"] == "llama2" and int(cfg.train.text_dim) == 4096
    for c in (jcfg, cfg):  # the tiny tower's width in place of Llama-2-7B's 4096
        c.train["text_dim"] = width
    want_router = _jax_router(jcfg, jax_tower)
    got_router = train_net.build_text_fn(cfg, port_tower_)
    assert got_router.prompts == want_router.prompts and len(got_router.prompts) == 10
    assert got_router.num_text == 1280 and got_router.bank.shape == (9, 1280, width)
    rng = np.random.RandomState(0)
    for group, phrases, n_valid in STEPS:
        batch = _batch(group, phrases, n_valid, rng)
        want = want_router({**batch, "targets": dict(batch["targets"])})
        got = got_router({**batch, "targets": dict(batch["targets"])})
        np.testing.assert_array_equal(got["targets"]["labels"], want["targets"]["labels"])
        for k in ("text_valid", "class_valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["text_features"].shape == (2, 1280, width)
        np.testing.assert_allclose(got["text_features"], want["text_features"], **TOL)
        np.testing.assert_allclose(got_router.bank, want_router.bank, **TOL)
        if phrases is None:  # the group's names, encoded once
            n = int(got["text_valid"][0].sum())
            assert n == {1: 365, 2: 601}[group] and np.abs(got["text_features"][0, :n]).min() > 0
        else:  # each valid box its own phrase, the bank padding behind them
            assert int(got["targets"]["labels"][got["targets"]["valid"]].max()) == sum(n_valid) - 1
    assert np.abs(got_router.bank[3, :7]).min() > 0  # VG's bank: its 5 + 2 phrases
    assert len(port_tower_._cache) == 2  # Objects365's and OpenImages' vocabularies
