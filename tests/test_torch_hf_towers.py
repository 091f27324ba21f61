"""The port's BERT, T5 and Llama-2 towers (``modeling/text/hf_wrappers.py``)
against JAX's wrappers (``ape_tpu/modeling/text/hf_wrappers.py``) on the
same tiny ``transformers`` models, carried across by
``checkpoint.convert.hf_text_state_dict``, and on the same saved
directories: ``last_hidden_state`` at the valid positions and
``last_hidden_state_eot`` within 1e-5 abs + 1e-5 rel in f32, masks and
``end_token_idx`` exact; left- and right-padded Llama rows, a chunk boundary
(``max_batch_size`` patched on both sides), the cache, T5's pooled return;
and a process with JAX, the JAX package, ``transformers``, ``safetensors``
and ``tokenizers`` refused loads a saved directory and encodes."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

from ape_tpu.modeling.text import hf_wrappers as jax_hf  # noqa: E402
from ape_tpu_torch.checkpoint.convert import hf_text_state_dict  # noqa: E402
from ape_tpu_torch.modeling.text import hf_wrappers as port_hf  # noqa: E402
from ape_tpu_torch.modeling.text.bpe import HFBPETokenizer  # noqa: E402
from ape_tpu_torch.modeling.text.wordpiece import WordPieceTokenizer  # noqa: E402
from tests.test_torch_hf_files import tiny_config, tiny_model, write_bert_vocab  # noqa: E402
from tests.test_torch_hf_tokenizers import write_llama_tokenizer  # noqa: E402
from tests.torch_config_tree import ROOT  # noqa: E402

TEXTS = ["a cat", "a photo of the dog", "red car on the table", "small blue sky", "x",
         "the dogs running", "café 日本 !"]
LLAMA_TEXTS = ["a cat", "a photo of the dog", "abc", "red dog", "the cat of the photo", "é🙂",
               "aaa"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_tower(kind: str, hf_model):
    """The port's tower with the ``transformers`` model's weights."""
    cfg = tiny_config(kind).to_dict()
    model = port_hf.build_tower(kind.split("-")[0], cfg, "cpu")
    flat = {k: v.detach().numpy() for k, v in hf_model.state_dict().items()}
    model.load_state_dict(hf_text_state_dict(flat, kind.split("-")[0]), strict=True)
    return model


def assert_same(want: dict, got: dict, keys=("last_hidden_state_eot",)):
    mask = _host(want["attention_mask"]).astype(bool)
    np.testing.assert_array_equal(_host(got["attention_mask"]), mask)
    np.testing.assert_allclose(_host(got["last_hidden_state"])[mask],
                               _host(want["last_hidden_state"])[mask], **TOL)
    for k in keys:
        np.testing.assert_allclose(_host(got[k]), _host(want[k]), **TOL)


@pytest.fixture(scope="module")
def bert_vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_vocab")
    write_bert_vocab(d)
    return d


@pytest.mark.parametrize("chunk", [None, 3])
def test_bert_equals_jax(bert_vocab, chunk):
    hf = tiny_model("bert")
    want_w = jax_hf.Bert(model=hf, tokenizer=transformers.BertTokenizer(
        str(bert_vocab / "vocab.txt")))
    got_w = port_hf.Bert(model=port_tower("bert", hf),
                         tokenizer=WordPieceTokenizer.from_dir(bert_vocab), device="cpu")
    if chunk:  # a chunk boundary inside the list, on both sides
        want_w.max_batch_size = got_w.max_batch_size = chunk
    want, got = want_w.forward_text(TEXTS), got_w.forward_text(TEXTS, cache=True)
    assert_same(want, got)
    assert _host(got["last_hidden_state"]).shape == (len(TEXTS), 256, 16)
    np.testing.assert_array_equal(_host(got["end_token_idx"]), want["end_token_idx"])
    assert got_w.forward_text(TEXTS, cache=True) is got
    assert got_w.forward_text(TEXTS) is not got


def test_t5_equals_jax(bert_vocab):
    """T5's encoder (relu and gated-gelu), pooled, returned bare as JAX's."""
    for kind in ("t5", "t5-gated"):
        hf = tiny_model(kind)
        want = jax_hf.T5(model=hf, tokenizer=transformers.BertTokenizer(
            str(bert_vocab / "vocab.txt"))).forward_text(TEXTS)
        got_w = port_hf.T5(model=port_tower(kind, hf),
                           tokenizer=WordPieceTokenizer.from_dir(bert_vocab), device="cpu")
        got = got_w.forward_text(TEXTS, cache=True)
        assert isinstance(got, torch.Tensor) and isinstance(want, np.ndarray)
        np.testing.assert_allclose(_host(got), want, **TOL)
        assert got_w.forward_text(TEXTS, cache=True) is got


@pytest.mark.parametrize("side,chunk", [("left", None), ("right", None), ("left", 2)])
def test_llama2_equals_jax(tmp_path, side, chunk):
    """Left padding (Llama's default) and right padding. Trait 28: the
    positions are 0..L-1 whatever the padding, so a left-padded text's
    tokens sit at positions set by the longest text of its list; RoPE sees
    only their differences, so its feature moves by rounding alone."""
    d = write_llama_tokenizer(tmp_path / "tok", padding_side=side)
    hf = tiny_model("llama2")
    want_w = jax_hf.Llama2(model=hf, tokenizer=transformers.AutoTokenizer.from_pretrained(str(d)))
    got_w = port_hf.Llama2(model=port_tower("llama2", hf), tokenizer=HFBPETokenizer.from_dir(d),
                           device="cpu")
    if chunk:
        want_w.max_batch_size = got_w.max_batch_size = chunk
    want, got = want_w.forward_text(LLAMA_TEXTS), got_w.forward_text(LLAMA_TEXTS)
    assert_same(want, got)
    assert np.isfinite(_host(got["last_hidden_state"])).all()
    alone = got_w.forward_text(LLAMA_TEXTS[:1])["last_hidden_state_eot"]
    np.testing.assert_allclose(_host(alone), _host(got["last_hidden_state_eot"][:1]), **TOL)


@pytest.fixture(scope="module")
def saved_dirs(tmp_path_factory):
    """A BERT directory (BertForMaskedLM's checkpoint, vocab.txt) and a
    Llama-2 one (LlamaForCausalLM's, tokenizer.json), both saved by
    ``save_pretrained``."""
    root = tmp_path_factory.mktemp("hf_towers")
    bert = root / "bert"
    tiny_model("bert", seed=1, head=True).save_pretrained(bert)
    write_bert_vocab(bert)
    llama = root / "llama"
    tiny_model("llama2", seed=2, head=True).save_pretrained(llama)
    write_llama_tokenizer(llama)
    return {"bert": bert, "llama2": llama}


def test_directories_load_as_jax_loads_them(saved_dirs):
    """``model_name_or_path``: JAX's wrappers through ``from_pretrained`` and
    ``AutoTokenizer``, the port's through its reader and tokenizers."""
    for kind, cls in (("bert", "Bert"), ("llama2", "Llama2")):
        path = str(saved_dirs[kind])
        texts = TEXTS if kind == "bert" else LLAMA_TEXTS
        want = getattr(jax_hf, cls)(path).forward_text(texts)
        got = port_hf.build_hf_text_model(kind, path, device="cpu").forward_text(texts)
        assert_same(want, got)


def test_factory_and_refusals(saved_dirs, tmp_path, monkeypatch):
    with pytest.raises(KeyError, match="'gpt2'"):
        port_hf.build_hf_text_model("gpt2", str(saved_dirs["bert"]), device="cpu")
    with pytest.raises(ValueError, match="model_name_or_path"):
        port_hf.Bert(device="cpu")
    # a T5 directory holds a sentencepiece Unigram tokenizer, which the port
    # does not read
    d = tmp_path / "t5"
    tiny_model("t5", head=True).save_pretrained(d)
    with pytest.raises(NotImplementedError, match="tokenizer.json"):
        port_hf.T5(str(d), device="cpu")
    from tokenizers import Tokenizer, models

    Tokenizer(models.Unigram([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁a", -1.0)],
                             unk_id=2)).save(str(d / "tokenizer.json"))
    with pytest.raises(NotImplementedError, match="Unigram"):
        port_hf.T5(str(d), device="cpu")
    # no card and no device named: the towers raise rather than fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_hf.Bert(str(saved_dirs["bert"]))


def test_t5_cannot_feed_the_text_router():
    """Trait 27: JAX's T5 returns an array and JAX's TextRouter indexes
    ``out["last_hidden_state_eot"]``, so no T5 tower feeds training; the
    port's does the same."""
    from ape_tpu.engine.text_router import TextRouter as JaxRouter
    from ape_tpu_torch.engine.text_router import TextRouter

    class Pooled:
        def forward_text(self, texts, cache=False):
            return np.zeros((len(texts), 4), np.float32)

    for router in (JaxRouter, TextRouter):
        with pytest.raises(IndexError):
            router(model_language=Pooled(), text_dim=4).encode(["a cat"])


RUN = textwrap.dedent("""
    import sys
    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "ape_tpu", "transformers",
                                      "safetensors", "tokenizers"):
                raise ImportError("refused: " + name)
    sys.meta_path.insert(0, Refuse())
    import torch
    from ape_tpu_torch.modeling.text import build_hf_text_model
    for kind, path in (("bert", sys.argv[1]), ("llama2", sys.argv[2])):
        out = build_hf_text_model(kind, path, device="cpu").forward_text(["a cat", "the dog"])
        assert torch.isfinite(out["last_hidden_state_eot"]).all(), kind
        print(kind, tuple(out["last_hidden_state_eot"].shape))
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "ape_tpu", "transformers",
                                                            "safetensors", "tokenizers")]
    assert not leaked, leaked
""")


def test_towers_load_without_transformers(saved_dirs):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", RUN, str(saved_dirs["bert"]),
                          str(saved_dirs["llama2"])], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "bert (2, 16)" in res.stdout and "llama2 (2, 32)" in res.stdout
