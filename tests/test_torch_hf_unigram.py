"""T5's own tokenizer in the port (``modeling/text/unigram.py`` on the shared
``hf_pipeline``, with ``charsmap`` and ``graphemes``) against the
``T5TokenizerFast`` that ``transformers.AutoTokenizer`` reads from the same
directory (JAX's call: "longest" padding), ids and masks exact:

- both T5 file forms: the hub's older one (``Precompiled`` alone, then
  ``WhitespaceSplit`` and ``Metaspace(add_prefix_space=true)``) and
  T5Converter's (``Precompiled``, ``Strip(right)``, ``Replace(" {2,}",
  "▁")``, ``Metaspace`` with ``prepend_scheme`` "always" or "first"), with
  and without ``byte_fallback``, single texts and pairs, on fixed texts and
  on 150 hypothesis strings per form over combining marks, Hangul jamo,
  emoji with ZWJ, regional indicators, Devanagari conjuncts, fullwidth
  forms, runs of spaces, tabs and added tokens;
- the ``Precompiled`` normalizer alone against
  ``tokenizers.normalizers.Precompiled(...).normalize_str`` on a charsmap
  with multi-code-point keys, keys that are prefixes of others, deletions
  and expansions;
- the shipped grapheme table, derived again from ``regex`` and held against
  ``tokenizers``' own segmentation (``tools/make_grapheme_table.py``);
- ``tokenizer_config.json``'s additions (extra ids that ``tokenizer.json``
  lacks, additional special tokens, ``extra_ids`` disagreeing), and what the
  reader refuses;
- JAX's ``T5(path)`` against the port's ``T5(path, device="cpu")`` on a
  tiny T5 and a tiny MT5 that ``transformers`` saved with such a tokenizer;
- the smoke's T5-base tokenizer (``chip_smoke.write_t5_tokenizer``): the
  SHA-256 of the 1203 names' ids that the smoke pins, from both."""

import base64
import functools
import hashlib
import json
import os
import tempfile
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from ape_tpu.modeling.text import hf_wrappers as jax_hf  # noqa: E402
from ape_tpu_torch.modeling.text import graphemes  # noqa: E402
from ape_tpu_torch.modeling.text import hf_wrappers as port_hf  # noqa: E402
from ape_tpu_torch.modeling.text.charsmap import Charsmap, build_charsmap  # noqa: E402
from ape_tpu_torch.modeling.text.unigram import HFUnigramTokenizer  # noqa: E402
from tests.torch_parity import cap_torch_threads  # noqa: E402,F401 (caps torch threads a worker)

EXTRA_IDS = 100
# NFKC's own mappings of these, as a real charsmap holds them
NFKC_CHARS = "ＡＢＣａｂｃ！\u3000ﬁﬃ①½™ｶﾞ¨²Ⅷǅ\u00a0"
# keys of more than one code point, keys that are prefixes of other keys
# (the shorter one wins a whole-grapheme lookup), deletions and expansions
CHARSMAP_EXTRA = {"e\u0301": "é", "a\u0308": "ä", "ｶﾞ": "ガ", "가": "가", "ab": "Q",
                  "u": "u", "u\u0308": "ü", "\u200b": "", "\u00ad": "", "\t": " ",
                  "\r\n": "\n", "क\u094dष": "K", "🇺🇸": "US", "&": "and"}
PIECES = (["▁", "a", "b", "c", "d", "e", "g", "h", "i", "n", "o", "r", "s", "t", "u", "x", "é", "ä",
           "ü", "1", "f", "k", "K", "Q", "!", "と", "カ", "ガ", "가", "ab", "bc", "abc", "▁a", "▁c",
           "▁ca", "at", "▁cat", "▁d", "og", "▁dog", "he", "▁the", "th", "▁t", "is", "▁is", "fi",
           "▁fi", "ffi", "▁x", "xx", "▁ab", "▁abc", "▁é", "US", "and", "▁and", "TM", "▁1", "2"])


def _scores(pieces):
    """Seeded scores in halves, so that equal sums tie (a + bc, ab + c and
    a + b + c all score -6): the Viterbi's tie-break shows."""
    rng = np.random.RandomState(7)
    out = {p: -float(rng.randint(2, 20)) / 2 for p in pieces}
    out.update({"a": -2.0, "b": -2.0, "c": -2.0, "ab": -4.0, "bc": -4.0, "abc": -6.0})
    return out


def charsmap_blob() -> bytes:
    mapping = {c: unicodedata.normalize("NFKC", c) for c in NFKC_CHARS}
    mapping.update(CHARSMAP_EXTRA)
    return build_charsmap(mapping)


def write_t5_tokenizer(d: Path, form: str = "always", byte_fallback: bool = False,
                       config=None, model_type: str = "t5", extra_in_json: bool = True) -> Path:
    """A T5 tokenizer directory: ``tokenizer.json`` built by ``tokenizers``
    (a Unigram over PIECES with <pad> 0, </s> 1, <unk> 2, the 256 byte
    pieces under ``byte_fallback``, T5Converter's reversed <extra_id_*>
    at the end unless ``extra_in_json`` is false), in ``form`` "hub" (the
    older form, no tokenizer_config.json), "always" or "first"
    (T5Converter's, tokenizer_config.json naming T5Tokenizer, or ``config``),
    and, where the directory has none, a ``config.json`` of ``model_type``."""
    from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers
    from tokenizers import pre_tokenizers, processors

    scores = _scores(PIECES)
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    if byte_fallback:
        vocab += [(f"<0x{b:02X}>", 0.0) for b in range(256)]
    vocab += [(p, scores[p]) for p in PIECES]
    if extra_in_json:
        vocab += [(f"<extra_id_{i}>", 0.0) for i in range(EXTRA_IDS - 1, -1, -1)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2, byte_fallback=byte_fallback))
    pre = normalizers.Precompiled(charsmap_blob())
    if form == "hub":
        tok.normalizer = pre
        tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                                     pre_tokenizers.Metaspace()])
    else:
        tok.normalizer = normalizers.Sequence([pre, normalizers.Strip(left=False, right=True),
                                               normalizers.Replace(Regex(" {2,}"), "▁")])
        tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme=form)
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"], special_tokens=[("</s>", 1)])
    specials = ["<pad>", "</s>", "<unk>"]
    if extra_in_json:
        specials += [f"<extra_id_{i}>" for i in range(EXTRA_IDS - 1, -1, -1)]
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in specials])
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    if form == "hub":  # the hub's serialization of Metaspace
        spec = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
        spec["pre_tokenizer"]["pretokenizers"][1] = {"type": "Metaspace", "replacement": "▁",
                                                     "add_prefix_space": True}
        (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    else:
        (d / "tokenizer_config.json").write_text(json.dumps(
            config if config is not None else {"tokenizer_class": "T5Tokenizer",
                                               "eos_token": "</s>", "unk_token": "<unk>",
                                               "pad_token": "<pad>", "extra_ids": EXTRA_IDS}))
    if not (d / "config.json").is_file():  # a saved model's own stays
        (d / "config.json").write_text(json.dumps({"model_type": model_type}))
    return d


FORMS = [("hub", False), ("always", False), ("first", False), ("always", True), ("first", True)]
TEXTS = ["a cat", "the dog", "abc", "ab c", "  lead and trail  ", "a\tcat\t\tdog", "", " ",
         "ＡＢＣ！\u3000ａｂｃ", "ﬁﬃ ① ½ ™ Ⅷ ǅ ²", "cafe\u0301 a\u0308 u\u0308 é", "ｶﾞカ", "가 가",
         "क\u094dष\u093f", "🇺🇸🇫", "👨\u200d👩\u200d👧 🏽", "x<extra_id_0>y", "<extra_id_0>a",
         "a </s> b<pad>",
         "<unk><unk>z", "\u200bab", "\u200b a", "\u00ad", "¨a", "a  b   c", "x\r\ny\r", "🙂🙂 ☃",
         "日本 語", "<extra_id_99><extra_id_9>", "& and&", "a\u00a0b", "\u3000x"]


@functools.lru_cache(maxsize=None)
def _pair(form: str, byte_fallback: bool):
    """(AutoTokenizer's, the port's) on write_t5_tokenizer's directory."""
    d = write_t5_tokenizer(Path(tempfile.mkdtemp(prefix="t5_tok_")) / "tok", form, byte_fallback)
    return transformers.AutoTokenizer.from_pretrained(str(d)), port_hf.load_tokenizer("t5", d)


@pytest.mark.parametrize("form,byte_fallback", FORMS)
def test_unigram_equals_t5_tokenizer_fast(form, byte_fallback):
    """JAX's call on the fixed texts, ids and masks exact; then pairs."""
    want, got = _pair(form, byte_fallback)
    assert isinstance(got, HFUnigramTokenizer) and type(want).__name__ == "T5TokenizerFast"
    assert got.padding_side == want.padding_side == "right"
    assert got.pad_id == want.pad_token_id == 0
    w, g = want(TEXTS, padding="longest"), got(TEXTS)
    for i, text in enumerate(TEXTS):
        assert g["input_ids"][i].tolist() == w["input_ids"][i], (form, text)
    np.testing.assert_array_equal(g["attention_mask"], w["attention_mask"])
    pairs = TEXTS[::-1]
    w, g = want(TEXTS, pairs, padding="longest"), got(TEXTS, pairs)
    np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
    np.testing.assert_array_equal(g["attention_mask"], w["attention_mask"])


FRAGMENTS = (list("abcdeghinorstux!&1") + ["\u0301", "\u0308", "\u0327", "ᄀ", "ᅡ",
             "ᆨ", "가", "👨", "👩", "👧", "\u200d", "🏽", "🇺", "🇸", "🇫", "क", "\u094d",
             "ष", "\u093f", "Ａ", "ｂ", "！", "\u3000", "ｶ", "ﾞ", "ﬁ", "①", "¨", "\u200b", "\u00ad",
             "\u0600", "\r", "\n", "\t", "\t\t", " ", "  ", "   ", "▁", "<extra_id_0>",
             "<extra_id_57>", "</s>", "<pad>", "<unk>", "<extra_id_", "🙂", "日"])


@pytest.mark.parametrize("form,byte_fallback", FORMS)
@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.lists(st.sampled_from(FRAGMENTS), max_size=24).map("".join))
def test_unigram_random_strings(form, byte_fallback, text):
    want, got = _pair(form, byte_fallback)
    assert got.encode(text) == want(text)["input_ids"], (form, text)


def _variant_spec(name: str):
    """(normalizer, pre-tokenizer) of a pipeline the T5 forms do not run:
    Metaspace "first" after WhitespaceSplit (a word's alignment decides),
    after Strip(left) and a Replace that inserts ▁, without its split, and
    Prepend before Precompiled with a Regex Replace and "never"."""
    from tokenizers import Regex, normalizers, pre_tokenizers

    pre = normalizers.Precompiled(charsmap_blob())
    return {
        "ws_first": (pre, pre_tokenizers.Sequence([
            pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Metaspace(prepend_scheme="first")])),
        "strip_first": (normalizers.Sequence([pre, normalizers.Strip(left=True, right=True),
                                              normalizers.Replace("a", "▁▁")]),
                        pre_tokenizers.Metaspace(prepend_scheme="first")),
        "prepend_never": (normalizers.Sequence([normalizers.Prepend("▁"), pre,
                                                normalizers.Replace(Regex("b+"), "B")]),
                          pre_tokenizers.Metaspace(prepend_scheme="never", split=False)),
        "first_nosplit": (pre, pre_tokenizers.Metaspace(prepend_scheme="first", split=False)),
    }[name]


@functools.lru_cache(maxsize=None)
def _variant_pair(name: str):
    """(AutoTokenizer's, the port's) on a variant pipeline with a
    normalized added token of one word ("dog") and of two ("x y"), matched
    after the normalizer, and a non-special raw one ("<t>")."""
    from tokenizers import AddedToken, Tokenizer, models, processors

    scores = _scores(PIECES)
    vocab = ([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)] + [(p, scores[p]) for p in PIECES]
             + [("B", -1.0), ("▁▁", -3.0)])
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.normalizer, tok.pre_tokenizer = _variant_spec(name)
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"], special_tokens=[("</s>", 1)])
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in ("<pad>", "</s>", "<unk>")])
    tok.add_tokens([AddedToken("dog", normalized=True), AddedToken("x y", normalized=True),
                    AddedToken("<t>", normalized=False, special=False)])
    d = Path(tempfile.mkdtemp(prefix="t5_variant_")) / name
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "T5Tokenizer", "extra_ids": 0, "additional_special_tokens": []}))
    return transformers.AutoTokenizer.from_pretrained(str(d)), port_hf.load_tokenizer("t5", d)


@pytest.mark.parametrize("name", ["ws_first", "strip_first", "prepend_never", "first_nosplit"])
@settings(max_examples=150, deadline=None, derandomize=True)
@given(st.lists(st.sampled_from(FRAGMENTS + ["dog", " dog", "x y", "<t>", "\u00a8", "a"]),
                max_size=16).map("".join))
def test_pipeline_variants_random_strings(name, text):
    """Where the alignment decides (Metaspace "first" on a piece that does
    or does not start at the original's offset 0, after a deletion, an
    expansion, a strip or a split), ids exact."""
    want, got = _variant_pair(name)
    assert got.encode(text) == want(text)["input_ids"], (name, text)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.sampled_from(FRAGMENTS + ["e\u0301", "u\u0308", "ab", "ｶﾞ", "🇺🇸", "\r\n"]),
                max_size=24).map("".join))
def test_precompiled_equals_tokenizers(text):
    """The ``Precompiled`` normalizer alone, ``normalize_str``'s string."""
    blob = charsmap_blob()
    want = tokenizers.normalizers.Precompiled(blob).normalize_str(text)
    assert Charsmap(blob).normalize(text) == want


def test_precompiled_quirks_and_blob():
    """The quirks the module names, held against ``tokenizers``: a key of
    several characters rewrites only a grapheme that holds them, the
    shortest key that is a prefix of a grapheme rewrites all of it, a
    grapheme of 6 bytes or more is looked up a character at a time; and the
    blob round-trips through base64 as ``tokenizer.json`` carries it."""
    blob = charsmap_blob()
    want = tokenizers.normalizers.Precompiled(blob).normalize_str
    cmap = Charsmap.from_base64(base64.b64encode(blob).decode())
    cases = {"abc": "abc", "e\u0301": "é", "u\u0308x": "ux", "ｶﾞ": "カ\u3099", "ＡＢ": "AB",
             "\u200bq": "q", "ﬃ": "ffi"}
    for text, out in cases.items():
        assert cmap.normalize(text) == want(text) == out, text
    with pytest.raises(ValueError, match="shorter than its header"):
        Charsmap(b"")


def test_grapheme_table_is_rederived_and_held_against_tokenizers():
    """``make_grapheme_table.derive`` over every code point: ``regex``'s
    classes, moved where ``tokenizers``' segmentation (seen through the
    ``Precompiled`` probe) disagrees, render the shipped table byte for
    byte; the derivation checks the result against the probe."""
    pytest.importorskip("regex")
    from ape_tpu_torch.tools import make_grapheme_table as mk

    assert mk.render(mk.derive()) == mk.TABLE.read_text(encoding="utf-8")


@pytest.mark.parametrize("text,clusters", [
    ("a\u0301b", ["a\u0301", "b"]), ("\r\n\n", ["\r\n", "\n"]), ("각", ["각"]),
    ("각", ["각"]), ("🇺🇸🇫", ["🇺🇸", "🇫"]),
    ("👨\u200d👩", ["👨\u200d👩"]), ("क\u094dष", ["क\u094dष"]), ("\u0600a", ["\u0600a"]),
    ("a\u200db", ["a\u200d", "b"]), ("ｶﾞ", ["ｶﾞ"]), ("क\u093f", ["क\u093f"])])
def test_grapheme_rules(text, clusters):
    """GB3, GB6-GB8 (Hangul), GB9/GB9a, GB9b, GB9c (Indic conjuncts), GB11
    (emoji ZWJ), GB12/13 (regional indicator pairs), each against
    ``regex``'s ``\\X`` where it follows the same Unicode rules."""
    assert graphemes.graphemes(text) == clusters
    regex = pytest.importorskip("regex")
    assert regex.findall(r"\X", text) == clusters


def test_config_additions_as_transformers_adds_them(tmp_path):
    """Extra ids that tokenizer.json lacks are added at the next ids in
    order (<extra_id_0> first), additional special tokens beside them, a
    saved directory reads back the same; disagreeing ``extra_ids`` raise on
    both sides."""
    cases = {
        "no_extra": {"tokenizer_class": "T5Tokenizer"},
        "additional": {"tokenizer_class": "T5Tokenizer", "extra_ids": 3,
                       "additional_special_tokens": ["<sep>", "cat"]},
        "mt5": {},
    }
    texts = ["a cat<extra_id_2><sep>", "<extra_id_0> the dog", "cat<extra_id_99>"]
    for name, cfg in cases.items():
        d = write_t5_tokenizer(tmp_path / name, "always", config=cfg, extra_in_json=False,
                               model_type="mt5" if name == "mt5" else "t5")
        want = transformers.AutoTokenizer.from_pretrained(str(d))
        got = port_hf.load_tokenizer("t5", d)
        np.testing.assert_array_equal(got(texts)["input_ids"],
                                      want(texts, padding="longest")["input_ids"])
        assert got.token_id("<extra_id_0>") == want.convert_tokens_to_ids("<extra_id_0>")
        want.save_pretrained(tmp_path / f"{name}_saved")
        again = port_hf.load_tokenizer("t5", tmp_path / f"{name}_saved")
        np.testing.assert_array_equal(again(texts)["input_ids"], got(texts)["input_ids"])
    d = write_t5_tokenizer(tmp_path / "bad", "always", config={
        "tokenizer_class": "T5Tokenizer", "extra_ids": 2,
        "additional_special_tokens": ["<extra_id_0>"]})
    with pytest.raises(ValueError, match="extra_ids"):
        transformers.AutoTokenizer.from_pretrained(str(d))
    with pytest.raises(ValueError, match="extra_ids"):
        port_hf.load_tokenizer("t5", d)


@pytest.mark.parametrize("edit,named", [
    (lambda s: s["normalizer"]["normalizers"].append({"type": "NFKC"}), "NFKC"),
    (lambda s: s["normalizer"]["normalizers"].__setitem__(
        2, {"type": "Replace", "pattern": {"Regex": " +?"}, "content": "▁"}), "Regex"),
    (lambda s: s.update(pre_tokenizer={"type": "Sequence", "pretokenizers": [
        {"type": "Punctuation", "behavior": "Isolated"}, s["pre_tokenizer"]]}), "Punctuation"),
    (lambda s: s["model"].update(type="WordPiece"), "WordPiece"),
    (lambda s: s["added_tokens"][1].update(rstrip=True), "rstrip"),
    (lambda s: s.update(post_processor={"type": "RobertaProcessing"}), "RobertaProcessing"),
])
def test_unigram_refuses_what_it_does_not_read(tmp_path, edit, named):
    d = write_t5_tokenizer(tmp_path / "tok", "always")
    spec = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
    edit(spec)
    with pytest.raises(NotImplementedError, match=named):
        HFUnigramTokenizer(spec, {"tokenizer_class": "T5Tokenizer"})


def _tiny_seq2seq(kind: str, seed: int):
    """A seeded tiny T5ForConditionalGeneration ("t5", relu) or
    MT5ForConditionalGeneration ("mt5", gated-gelu, untied head) whose
    vocabulary holds write_t5_tokenizer's ids."""
    cfg = dict(vocab_size=192, d_model=16, d_kv=8, d_ff=32, num_layers=2, num_heads=2,
               relative_attention_num_buckets=8, relative_attention_max_distance=16)
    torch.manual_seed(seed)
    if kind == "mt5":
        model = transformers.MT5ForConditionalGeneration(transformers.MT5Config(**cfg))
    else:
        model = transformers.T5ForConditionalGeneration(transformers.T5Config(**cfg))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return model.eval()


@pytest.mark.parametrize("kind", ["t5", "mt5"])
def test_t5_directory_equals_jax(tmp_path, kind):
    """JAX's ``T5(path)`` (AutoModelForSeq2SeqLM, AutoTokenizer) against the
    port's ``T5(path, device="cpu")`` on a directory ``save_pretrained``
    wrote with the tokenizer: the pooled features within
    ``test_t5_equals_jax``'s tolerance, and the tokenizer's ids exact."""
    from tests.test_torch_hf_towers import TOL

    d = tmp_path / kind
    _tiny_seq2seq(kind, seed=3).save_pretrained(d)
    write_t5_tokenizer(d, "first", model_type=kind)
    texts = TEXTS[:18]
    jax_tower = jax_hf.T5(str(d))
    assert type(jax_tower.model).__name__ == ("MT5" if kind == "mt5" else "T5") + \
        "ForConditionalGeneration"
    want = jax_tower.forward_text(texts)
    got_w = port_hf.T5(str(d), device="cpu")
    got = got_w.forward_text(texts)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape == (len(texts), 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got_w.tokenizer(texts)["input_ids"],
                                  jax_tower.tokenizer(texts, padding="longest")["input_ids"])


def test_smoke_t5_tokenizer_digest(tmp_path):
    """The smoke's T5-base tokenizer (32,000 pieces from the names, 100
    extra ids, T5Converter's pipeline, a charsmap of the 4,928 NFKC
    mappings): AutoTokenizer and the port give the 1203 names the same ids,
    whose SHA-256 is the one ``chip_smoke`` pins."""
    import chip_smoke

    d = tmp_path / "t5"
    chip_smoke.write_t5_tokenizer(d, chip_smoke.hf_names())
    spec = json.loads((d / "tokenizer.json").read_text(encoding="utf-8"))
    assert len(spec["model"]["vocab"]) == 32100 and len(spec["added_tokens"]) == 103
    blob = base64.b64decode(spec["normalizer"]["normalizers"][0]["precompiled_charsmap"])
    assert Charsmap(blob).transform("ﬁ") == "fi"
    names = list(chip_smoke.hf_names())
    want = transformers.AutoTokenizer.from_pretrained(str(d))(names, padding="longest")
    got = port_hf.load_tokenizer("t5", d)(names)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    digest = hashlib.sha256(np.asarray(want["input_ids"], "<i8").tobytes()).hexdigest()
    assert digest == chip_smoke.T5_IDS_SHA256
    assert chip_smoke.t5_ids_digest(got) == digest
