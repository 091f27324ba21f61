"""The port's text side against ape_tpu's on the CPU, in f32: the tokenizer
copy (the hash fallback, the BPE on a small merges file, the ``re`` pattern
the CUDA machine falls back to), the EVA-CLIP text tower on token ids (atol
1e-4), ``EVA02CLIP.forward_text`` through the HashTokenizer in one process
(its four outputs, chunks and pad rows, the cache), ``reduce_language_
feature``, the language weights' round trip, the device rule, and the import
closure without JAX or ``regex``.

The HashTokenizer hashes with Python's salted ``hash()``: its ids agree
between the two packages within one process, not between processes."""

import gzip
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.modeling.text import clip_text as j_clip
from ape_tpu.modeling.text import tokenizer as j_tok
from ape_tpu.modeling.text import wrapper as j_wrapper
from ape_tpu_torch.checkpoint.convert import language_state_dict_from_jax
from ape_tpu_torch.modeling.text import clip_text, tokenizer, wrapper
from tests.torch_parity import flatten

ATOL = 1e-4
TOWER = dict(vocab_size=49408, context_length=77, width=64, heads=4, layers=2, output_dim=48)
PROMPTS = ["person", "a person riding a bike", "Traffic  light", "&amp; hot dog", "",
           "cat, dog, umbrella", " ".join(["word"] * 90)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _merges(path: Path):
    """A small merges file in the format of bpe_simple_vocab_16e6.txt.gz."""
    merges = ["#version: 0.2", "p e", "r s", "o n</w>", "pe rs", "pers on</w>", "c a", "ca t</w>",
              "d o", "do g</w>", "b i", "bi k", "bik e</w>", "t h", "th e</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    return str(path)


def test_tokenizers_match_ape_tpu(tmp_path):
    vocab = _merges(tmp_path / "bpe.txt.gz")
    np.testing.assert_array_equal(tokenizer.HashTokenizer()(PROMPTS),
                                  j_tok.HashTokenizer()(PROMPTS))
    got, want = tokenizer.BPETokenizer(vocab), j_tok.BPETokenizer(vocab)
    np.testing.assert_array_equal(got(PROMPTS, 16), want(PROMPTS, 16))
    assert got.vocab_size == want.vocab_size and got.sot == want.sot and got.eot == want.eot
    assert isinstance(tokenizer.get_tokenizer(None), tokenizer.HashTokenizer)
    assert isinstance(tokenizer.get_tokenizer(str(tmp_path / "missing.gz")),
                      tokenizer.HashTokenizer)
    assert isinstance(tokenizer.get_tokenizer(vocab), tokenizer.BPETokenizer)


def test_bpe_re_fallback_matches_regex_on_ascii(tmp_path, monkeypatch):
    """Without ``regex`` the BPE pattern falls back to ``re``; on ASCII
    prompts it splits as CLIP's \\p{L}/\\p{N} pattern does."""
    vocab = _merges(tmp_path / "bpe.txt.gz")
    want = j_tok.BPETokenizer(vocab)(PROMPTS + ["it's 2 cats!", "The 3rd bike's seat"])
    fallback = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                          r"""[^\W\d_]+|\d|[^\s\w]+""", re.IGNORECASE | re.UNICODE)
    monkeypatch.setattr(tokenizer.BPETokenizer, "PAT", fallback)
    got = tokenizer.BPETokenizer(vocab)(PROMPTS + ["it's 2 cats!", "The 3rd bike's seat"])
    np.testing.assert_array_equal(got, want)


def _tower_pair(seed=0):
    """JAX's CLIPTextTransformer with flax-initialised params and the port's
    tower with the same weights."""
    jm = j_clip.CLIPTextTransformer(**TOWER)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 77), jnp.int32))["params"]
    flat = {k: np.asarray(v) for k, v in flatten(jax.tree_util.tree_map(np.asarray,
                                                                        params)).items()}
    pm = clip_text.CLIPTextTransformer(**TOWER)
    pm.load_state_dict(language_state_dict_from_jax(flat), strict=True)
    return jm, params, flat, pm.eval()


def test_text_tower_on_token_ids(rng):
    """End-of-text and per-token features on random ids, the end token the
    highest id at a different place in each row, and an all-pad row."""
    jm, params, _, pm = _tower_pair()
    tokens = np.zeros((4, 77), np.int32)
    for i, n in enumerate((3, 10, 77)):
        tokens[i, :n] = rng.randint(1, 400, n)
        tokens[i, n - 1] = 49407
    tokens[3, 0] = 49406
    want_eot, want_seq = jm.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got_eot, got_seq = pm(_t(tokens).long())
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), atol=ATOL)
    np.testing.assert_allclose(got_eot.numpy(), np.asarray(want_eot), atol=ATOL)


def test_forward_text_through_the_hash_tokenizer():
    """EVA02CLIP.forward_text in chunks of 3 prompts (7 prompts: the last
    chunk padded with start-token rows), against JAX's on the same weights;
    the cache hands back the same result; encode_text its EOT features."""
    jax_clip = j_wrapper.EVA02CLIP(max_batch_size=3, **TOWER)
    flat = flatten(jax.tree_util.tree_map(np.asarray, jax_clip.params))
    port = wrapper.EVA02CLIP(language_state_dict_from_jax(flat), max_batch_size=3,
                             device="cpu", **TOWER)
    want = jax_clip.forward_text(PROMPTS)
    got = port.forward_text(PROMPTS, cache=True)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["end_token_idx"].numpy(), np.asarray(want["end_token_idx"]))
    np.testing.assert_array_equal(got["attention_mask"].numpy(),
                                  np.asarray(want["attention_mask"]))
    for k in ("last_hidden_state", "last_hidden_state_eot"):
        assert got[k].shape == (len(PROMPTS),) + np.asarray(want[k]).shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)
    assert port.forward_text(PROMPTS, cache=True) is got
    np.testing.assert_array_equal(port.encode_text(PROMPTS[:2])["last_hidden_state_eot"].numpy(),
                                  got["last_hidden_state_eot"][:2].numpy())


@pytest.mark.parametrize("reduce_type", ["average", "max", "last"])
def test_reduce_language_feature(rng, reduce_type):
    feats = rng.randn(3, 6, 8).astype(np.float32)
    mask = np.arange(6)[None] < np.asarray([[6], [2], [4]])
    want = j_wrapper.reduce_language_feature(jnp.asarray(feats), jnp.asarray(mask), reduce_type)
    got = wrapper.reduce_language_feature(_t(feats), _t(mask), reduce_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_language_weight_round_trip():
    """convert_language_state_dict(language_state_dict_from_jax(flat)) ==
    flat, key for key, bit for bit."""
    from ape_tpu.checkpoint.convert import convert_language_state_dict

    _, _, flat, _ = _tower_pair(seed=1)
    sd = language_state_dict_from_jax(flat)
    back = convert_language_state_dict({k: v.numpy() for k, v in sd.items()})
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(KeyError, match="no rule"):
        language_state_dict_from_jax({**flat, "resblocks_0/extra/kernel": flat["text_projection"]})


def test_text_tower_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wrapper.EVA02CLIP(**TOWER)
    tower = wrapper.EVA02CLIP(device="cpu", **TOWER)
    assert {p.device.type for p in tower.model.parameters()} == {"cpu"}


def test_text_import_closure_without_jax_or_regex(tmp_path):
    """In a fresh interpreter that refuses jax, flax, PIL, the JAX package
    and ``regex`` (the CUDA machine has none), the text modules import, the
    BPE tokenizer takes the ``re`` pattern, and the tower encodes."""
    vocab = _merges(tmp_path / "bpe.txt.gz")
    code = textwrap.dedent(f"""
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL", "ape_tpu",
                                          "experiments", "regex"):
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        import re, torch
        torch.set_num_threads(2)
        from ape_tpu_torch.modeling.text import EVA02CLIP, BPETokenizer
        from ape_tpu_torch.checkpoint import language_state_dict_from_jax
        tok = BPETokenizer({vocab!r})
        assert isinstance(tok.PAT, re.Pattern)
        assert tok(["a person"], 8).shape == (1, 8)
        out = EVA02CLIP(width=32, heads=2, layers=1, output_dim=16,
                        device="cpu").forward_text(["cat", "a dog"])
        assert tuple(out["last_hidden_state_eot"].shape) == (2, 16)
        print("ok")
    """)
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
