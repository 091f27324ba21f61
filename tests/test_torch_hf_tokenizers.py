"""The port's tokenizers against ``transformers``' on the same files:
``wordpiece.WordPieceTokenizer`` against ``transformers.BertTokenizer`` on a
handwritten ``vocab.txt`` (JAX's Bert call: 256, "max_length" padding,
truncation), and ``bpe.HFBPETokenizer`` against the ``LlamaTokenizerFast``
that ``AutoTokenizer`` reads from a Llama-style byte-fallback BPE
``tokenizer.json`` built in memory by ``tokenizers`` (JAX's Llama2 call:
"longest" padding), on the left and the right; ids and masks exact, also over
random strings. Files the port does not read (a normalizer or a
pre-tokenizer it has no counterpart of, an added-token flag, BPE dropout)
raise ``NotImplementedError`` naming the type, and a Llama directory
without a pad token raises ``ValueError`` on both sides (trait 26)."""

import functools
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from ape_tpu_torch.modeling.text.bpe import HFBPETokenizer  # noqa: E402
from ape_tpu_torch.modeling.text.wordpiece import WordPieceTokenizer  # noqa: E402
from tests.test_torch_hf_files import write_bert_vocab  # noqa: E402

LLAMA_CHARS = "▁abcdefghijklmnopqrstuvwxyzé"
LLAMA_MERGES = [("▁", "a"), ("▁", "c"), ("a", "t"), ("▁c", "at"), ("▁", "d"), ("o", "g"),
                ("▁d", "og"), ("▁", "p"), ("h", "o"), ("▁p", "ho"), ("t", "o"), ("▁pho", "to"),
                ("a", "a"), ("aa", "a"), ("▁", "t"), ("h", "e"), ("▁t", "he"), ("▁", "o"),
                ("▁o", "f"), ("e", "d"), ("▁", "r"), ("▁r", "ed"), ("a", "b"), ("ab", "c"),
                ("b", "c"), ("a", "bc")]


def write_llama_tokenizer(d, padding_side=None, pad_token="<unk>", add_eos=False):
    """A Llama-2-style ``tokenizer.json`` (byte-fallback BPE, fused unk,
    Prepend + Replace, ``<s>`` template) and a ``tokenizer_config.json``
    naming LlamaTokenizer; ids below 320."""
    from tokenizers import AddedToken, Tokenizer, models, normalizers, processors

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for c in LLAMA_CHARS:
        vocab.setdefault(c, len(vocab))
    for a, b in LLAMA_MERGES:
        vocab.setdefault(a + b, len(vocab))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=LLAMA_MERGES, byte_fallback=True,
                               fuse_unk=True, unk_token="<unk>"))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True)
                            for t in ("<unk>", "<s>", "</s>")])
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    cfg = {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
           "unk_token": "<unk>", "pad_token": pad_token, "add_bos_token": True,
           "add_eos_token": add_eos, "legacy": True}
    if padding_side:
        cfg["padding_side"] = padding_side
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    return d


BERT_TEXTS = ["a cat", "A Photo of THE dogs!", "unaffable, cats.", "Café ÜBER 日本x",
              "[CLS] a [SEP] [MASK]", "[cls] [Sep]", "x" * 100, "x" * 101, "a " * 300,
              "\x00a‍b�", "🙂 dog", "  \t\n ", "", "red-car's on the table?",
              "ｆｕｌｌ width", "Ⅷ İstanbul ǅ"]


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_tok")
    write_bert_vocab(d)
    return d


@pytest.mark.parametrize("flags", [{}, {"do_lower_case": False}, {"strip_accents": False},
                                   {"tokenize_chinese_chars": False},
                                   {"never_split": ["Café"], "do_lower_case": False}])
def test_wordpiece_equals_bert_tokenizer(bert_dir, flags):
    """JAX's call (max_length 256, "max_length" padding, truncation) on
    accents, punctuation, CJK, emoji, special tokens in the text, a word of
    101 characters and a text cut at 256, under each flag."""
    want = transformers.BertTokenizer(str(bert_dir / "vocab.txt"), **flags)
    got = WordPieceTokenizer.from_dir(bert_dir)
    for k, v in flags.items():
        setattr(got, k, set(v) if k == "never_split" else v)
    kw = dict(max_length=256, padding="max_length", truncation=True)
    w, g = want(BERT_TEXTS, **kw), got(BERT_TEXTS, **kw)
    for i, text in enumerate(BERT_TEXTS):
        assert g["input_ids"][i].tolist() == w["input_ids"][i], text
    np.testing.assert_array_equal(g["attention_mask"], w["attention_mask"])
    assert g["input_ids"].shape == (len(BERT_TEXTS), 256)
    w, g = want(BERT_TEXTS[:4], padding="longest"), got(BERT_TEXTS[:4], padding="longest")
    np.testing.assert_array_equal(g["input_ids"], w["input_ids"])


def test_wordpiece_reads_the_directory_flags(tmp_path):
    write_bert_vocab(tmp_path)
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": False, "strip_accents": None,
         "model_max_length": 512}))
    tok = WordPieceTokenizer.from_dir(tmp_path)
    assert tok.do_lower_case is False and tok.strip_accents is None
    want = transformers.AutoTokenizer.from_pretrained(str(tmp_path), use_fast=False)
    np.testing.assert_array_equal(tok(BERT_TEXTS)["input_ids"],
                                  want(BERT_TEXTS, padding="longest")["input_ids"])


@functools.lru_cache(maxsize=None)
def _bert_pair():
    """(BertTokenizer, the port's) on the handwritten vocabulary."""
    d = Path(tempfile.mkdtemp(prefix="bert_vocab_"))
    write_bert_vocab(d)
    return transformers.BertTokenizer(str(d / "vocab.txt")), WordPieceTokenizer.from_dir(d)


@functools.lru_cache(maxsize=None)
def _llama_pair():
    """(LlamaTokenizerFast, the port's) on write_llama_tokenizer's files."""
    d = write_llama_tokenizer(Path(tempfile.mkdtemp(prefix="llama_tok_")) / "tok")
    return transformers.AutoTokenizer.from_pretrained(str(d)), HFBPETokenizer.from_dir(d)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=40))
def test_wordpiece_random_strings(text):
    want, got = _bert_pair()
    assert got.encode(text) == want.encode(text)


LLAMA_TEXTS = ["a cat", "a photo of the dog", "aaaa  aaa", "café über 🙂", "x<s>y</s>z", "",
               " lead", "日本", "\n\t", "abc abcabc", "red <unk> dog", "Ünïcødé ✓"]


@pytest.mark.parametrize("side", [None, "left", "right"])
def test_bpe_equals_llama_tokenizer_fast(tmp_path, side):
    """``AutoTokenizer``'s LlamaTokenizerFast from the same directory, JAX's
    call; ``padding_side`` from the config, else the class's "left"."""
    d = write_llama_tokenizer(tmp_path / "tok", padding_side=side)
    want = transformers.AutoTokenizer.from_pretrained(str(d))
    got = HFBPETokenizer.from_dir(d)
    assert got.padding_side == want.padding_side == (side or "left")
    w, g = want(LLAMA_TEXTS, padding="longest"), got(LLAMA_TEXTS)
    np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
    np.testing.assert_array_equal(g["attention_mask"], w["attention_mask"])


def test_bpe_add_eos_and_a_new_pad_token(tmp_path):
    """``add_eos_token`` rebuilds the template, and a pad token out of the
    vocabulary is added at the next id, as ``add_special_tokens`` adds it."""
    d = write_llama_tokenizer(tmp_path / "tok", pad_token="<pad>", add_eos=True)
    want = transformers.AutoTokenizer.from_pretrained(str(d))
    got = HFBPETokenizer.from_dir(d)
    w, g = want(LLAMA_TEXTS, padding="longest"), got(LLAMA_TEXTS)
    np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
    assert got.pad_id == want.pad_token_id


def test_bpe_code_llama_class(tmp_path):
    """``CodeLlamaTokenizer`` as ``AutoTokenizer`` reads it: Llama's
    template and left padding, and its four infilling tokens added at the
    next ids."""
    d = write_llama_tokenizer(tmp_path / "tok")
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    (d / "tokenizer_config.json").write_text(json.dumps(dict(cfg,
                                                             tokenizer_class="CodeLlamaTokenizer")))
    want = transformers.AutoTokenizer.from_pretrained(str(d))
    got = HFBPETokenizer.from_dir(d)
    texts = LLAMA_TEXTS + ["x▁<PRE>y ▁<EOT>", "▁<MID>▁<SUF>"]
    assert type(want).__name__ == "CodeLlamaTokenizerFast"
    assert got.padding_side == want.padding_side == "left"
    np.testing.assert_array_equal(got(texts)["input_ids"],
                                  want(texts, padding="longest")["input_ids"])
    assert got.token_id("▁<EOT>") == want.convert_tokens_to_ids("▁<EOT>")


@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.lists(st.sampled_from(list("ab cdthpoeéfr🙂日<>/\t") + ["<s>", "</s>", "é\u0301"]),
                max_size=30).map("".join))
def test_bpe_random_strings(text):
    want, got = _llama_pair()
    assert got.encode(text) == want(text)["input_ids"]


def test_bpe_without_a_pad_token_raises_as_jax(tmp_path):
    """Trait 26: JAX's Llama2 pads "longest" without setting a pad token, so
    a directory that names none is refused on both sides."""
    d = write_llama_tokenizer(tmp_path / "tok", pad_token=None)
    with pytest.raises(ValueError, match="pad"):
        transformers.AutoTokenizer.from_pretrained(str(d))(["a", "a cat"], padding="longest")
    with pytest.raises(ValueError, match="no pad token"):
        HFBPETokenizer.from_dir(d)(["a", "a cat"])


@pytest.mark.parametrize("edit,named", [
    (lambda s: s["model"].update(type="Unigram"), "Unigram"),
    (lambda s: s.update(normalizer={"type": "NFKC"}), "NFKC"),
    (lambda s: s.update(pre_tokenizer={"type": "BertPreTokenizer"}), "BertPreTokenizer"),
    (lambda s: s.update(post_processor={"type": "ByteLevel"}), "ByteLevel"),
    (lambda s: s["added_tokens"][0].update(lstrip=True), "lstrip"),
    (lambda s: s["model"].update(dropout=0.1), "dropout"),
])
def test_bpe_refuses_what_it_does_not_read(tmp_path, edit, named):
    d = write_llama_tokenizer(tmp_path / "tok")
    spec = json.loads((d / "tokenizer.json").read_text())
    edit(spec)
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    cfg["tokenizer_class"] = "PreTrainedTokenizerFast"
    with pytest.raises(NotImplementedError, match=named):
        HFBPETokenizer(spec, cfg)
