"""BERT's tokenizer from ``vocab.txt``, as ``transformers.BertTokenizer``
tokenizes: the special tokens split out of the text first, the rest
lowercased a character at a time under ``do_lower_case``; then the basic
tokenizer (control characters dropped, white space to spaces, spaces around
CJK characters, NFC, lowercasing and accent stripping, splits at
punctuation) and greedy longest-match WordPiece with ``##`` continuations
(a word over 100 characters, or one the vocabulary cannot spell, is
``[UNK]``); ``[CLS] ... [SEP]`` around each text.
"""

from __future__ import annotations

import re
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ape_tpu_torch.modeling.text.hf_files import pad_batch, read_tokenizer_config

MAX_INPUT_CHARS_PER_WORD = 100


def load_vocab(path) -> Dict[str, int]:
    """``vocab.txt``: a token a line, its id the line's index (a repeated
    token keeps its last line, as ``load_vocab`` does)."""
    vocab = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # every non-letter, non-digit ASCII character counts, as in BERT
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _strip_accents(text: str) -> str:
    return "".join(ch for ch in unicodedata.normalize("NFD", text)
                   if unicodedata.category(ch) != "Mn")


def _split_on_punctuation(text: str) -> List[str]:
    out: List[str] = []
    new_word = True
    for ch in text:
        if _is_punctuation(ch):
            out.append(ch)
            new_word = True
        else:
            if new_word:
                out.append("")
            new_word = False
            out[-1] += ch
    return out


class WordPieceTokenizer:
    """``BertTokenizer``'s tokenization and batch call (``__call__``) on
    ``vocab``; the flags are ``tokenizer_config.json``'s."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 tokenize_chinese_chars: bool = True, strip_accents: Optional[bool] = None,
                 never_split: Iterable[str] = (), do_basic_tokenize: bool = True,
                 unk_token: str = "[UNK]", sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 cls_token: str = "[CLS]", mask_token: str = "[MASK]",
                 padding_side: str = "right"):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = strip_accents
        self.never_split = set(never_split or ())
        self.do_basic_tokenize = do_basic_tokenize
        self.unk_token, self.sep_token, self.pad_token = unk_token, sep_token, pad_token
        self.cls_token, self.mask_token = cls_token, mask_token
        self.padding_side = padding_side
        specials = [t for t in (unk_token, sep_token, pad_token, cls_token, mask_token) if t]
        self.special_tokens = set(specials)
        # leftmost, then longest: the order a regex alternation tries
        self._special_re = re.compile("(" + "|".join(
            re.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True)) + ")")

    @classmethod
    def from_dir(cls, path) -> "WordPieceTokenizer":
        """The tokenizer of the directory ``path``: its ``vocab.txt`` under
        the flags and special tokens of its ``tokenizer_config.json`` and
        ``special_tokens_map.json``."""
        cfg = read_tokenizer_config(path)
        keys = ("do_lower_case", "tokenize_chinese_chars", "strip_accents", "never_split",
                "do_basic_tokenize", "unk_token", "sep_token", "pad_token", "cls_token",
                "mask_token", "padding_side")
        return cls(load_vocab(Path(path) / "vocab.txt"),
                   **{k: cfg[k] for k in keys if cfg.get(k) is not None})

    # ------------------------------------------------------------------
    def _basic(self, text: str) -> List[str]:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            ch = " " if _is_whitespace(ch) else ch
            out.append(f" {ch} " if self.tokenize_chinese_chars and _is_cjk(cp) else ch)
        words = []
        for word in unicodedata.normalize("NFC", "".join(out)).split():
            if word in self.never_split or word in self.special_tokens:
                words.append(word)
                continue
            if self.do_lower_case:
                word = word.lower()
                if self.strip_accents is not False:
                    word = _strip_accents(word)
            elif self.strip_accents:
                word = _strip_accents(word)
            words.extend(_split_on_punctuation(word))
        return " ".join(words).split()

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_INPUT_CHARS_PER_WORD:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for i, part in enumerate(self._special_re.split(text)):
            if i % 2:  # a special token
                tokens.append(part)
                continue
            if not part:
                continue
            if not self.do_basic_tokenize:  # (BertTokenizer then has no do_lower_case)
                for word in part.split():
                    tokens.extend(self._wordpiece(word))
                continue
            if self.do_lower_case:
                part = "".join(ch.lower() for ch in part)
            for word in self._basic(part):
                tokens.extend([word] if word in self.never_split or word in self.special_tokens
                              else self._wordpiece(word))
        return tokens

    def token_id(self, token: str) -> int:
        return self.vocab.get(token, self.vocab.get(self.unk_token))

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """``[CLS] ids [SEP]``, the ids cut on the right to fit
        ``max_length`` where given."""
        ids = [self.token_id(t) for t in self.tokenize(text)]
        if max_length is not None:
            ids = ids[: max(max_length - 2, 0)]
        return [self.token_id(self.cls_token)] + ids + [self.token_id(self.sep_token)]

    def __call__(self, texts: Sequence[str], padding: str = "longest",
                 max_length: Optional[int] = None, truncation: bool = False
                 ) -> Dict[str, np.ndarray]:
        """The batch of ``tokenizer(texts, padding=..., max_length=...,
        truncation=...)``: ``input_ids`` and ``attention_mask``, int64."""
        seqs = [self.encode(t, max_length if truncation else None) for t in texts]
        return pad_batch(seqs, self.vocab.get(self.pad_token), padding, max_length,
                         self.padding_side)
