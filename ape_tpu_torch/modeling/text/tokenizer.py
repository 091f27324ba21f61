"""CLIP byte-level BPE tokenizer (a copy of ``ape_tpu/modeling/text/tokenizer.py``,
which the port may not import).

Attribution: the BPE internals (``bytes_to_unicode``, ``get_pairs``, the merge
loop in ``BPETokenizer.bpe``) follow OpenAI CLIP's MIT-licensed
``SimpleTokenizer`` algorithm: bit-compatibility with CLIP checkpoints
requires the exact merge procedure.

Byte-level BPE over a merges file, whitespace/html cleanup, lowercasing,
``<start_of_text> ... <end_of_text>`` framing, fixed context length with
truncation that preserves the EOT token. Without the ``regex`` module (the
CUDA machine has none) the pattern falls back to ``re``, which matches
``\\p{L}`` as ``[^\\W\\d_]``.

The merges vocabulary is loaded from a user-provided path (the standard
``bpe_simple_vocab_16e6.txt.gz``, not in the repository); when absent,
:class:`HashTokenizer` is the deterministic fallback. It hashes words with
Python's ``hash()``, which is salted per process unless ``PYTHONHASHSEED`` is
set: its ids, and so the features, differ between processes, as the JAX
package's do.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte<->unicode table (reversible, no whitespace/control chars)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class BPETokenizer:
    """CLIP-compatible byte-level BPE."""

    # CLIP's pattern uses \p{L}/\p{N}; the `regex` module supports them
    # directly so non-ASCII prompts tokenize identically to the reference.
    try:
        import regex as _regex

        PAT = _regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            _regex.IGNORECASE,
        )
    except ImportError:
        PAT = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
            re.IGNORECASE | re.UNICODE,
        )

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in self.PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def __call__(self, texts: List[str], context_length: int = 77) -> np.ndarray:
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > context_length:
                toks = toks[: context_length - 1] + [self.eot]
            result[i, : len(toks)] = toks
        return result


class HashTokenizer:
    """Deterministic offline fallback: hashes whitespace-split words into a
    fixed vocab. NOT CLIP-compatible; exists so the full pipeline (tokenize ->
    encode -> align) runs without the BPE merges asset."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def __call__(self, texts: List[str], context_length: int = 77) -> np.ndarray:
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            words = whitespace_clean(basic_clean(text)).lower().split(" ")
            toks = [self.sot]
            for w in words:
                toks.append(hash(w) % (self.vocab_size - 2))
            toks.append(self.eot)
            if len(toks) > context_length:
                toks = toks[: context_length - 1] + [self.eot]
            result[i, : len(toks)] = toks
        return result


def get_tokenizer(bpe_path: Optional[str] = None):
    if bpe_path and os.path.exists(bpe_path):
        return BPETokenizer(bpe_path)
    return HashTokenizer()
