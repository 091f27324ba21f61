"""Llama-2's tokenizer from ``tokenizer.json``, as ``tokenizers`` and
``LlamaTokenizerFast`` encode a batch:

- the added tokens (``<unk>``, ``<s>``, ``</s>`` and the special tokens the
  tokenizer files name) split out of the raw text first;
- each other piece normalized: ``Prepend("▁")`` (a non-empty piece only),
  then ``Replace(" ", "▁")``; no pre-tokenizer, so a piece is one word;
- the BPE model on each word: a symbol a character, a character out of the
  vocabulary as its UTF-8 bytes ``<0x..>`` under ``byte_fallback`` or else
  ``unk`` (consecutive ones fused under ``fuse_unk``), then the merges applied
  lowest rank first, the leftmost of equal ranks first, as ``tokenizers``'
  ``Word::merge_all`` takes them from its queue;
- the ``TemplateProcessing`` post-processor (``LlamaTokenizerFast`` rebuilds
  it from ``add_bos_token``/``add_eos_token``), then padding on the
  tokenizer's ``padding_side`` with its ``pad_token``.

Any other model, normalizer, pre-tokenizer, post-processor or added-token
flag raises ``NotImplementedError`` naming it (T5's ``Unigram`` with its
``Precompiled`` normalizer among them); nothing is approximated.
"""

from __future__ import annotations

import heapq
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ape_tpu_torch.modeling.text.hf_files import (
    pad_batch,
    read_config,
    read_json,
    read_tokenizer_config,
)

# the tokenizer class a directory's model_type selects where
# tokenizer_config.json names none (AutoTokenizer's table)
_CLASS_OF_MODEL_TYPE = {"llama": "LlamaTokenizer", "t5": "T5Tokenizer"}
# the classes whose padding_side defaults to "left" and that rebuild the
# post-processor from add_bos_token/add_eos_token (transformers 4.57)
_LLAMA_CLASSES = {"LlamaTokenizer", "CodeLlamaTokenizer"}
_ADDED_TOKEN_FLAGS = ("single_word", "lstrip", "rstrip", "normalized")


def _refuse(what: str, value) -> None:
    raise NotImplementedError(f"tokenizer.json: {what} {value!r} is not supported (the port "
                              "reads the BPE model with Prepend/Replace normalizers only)")


def _normalizers(spec) -> list:
    """[("prepend", s) or ("replace", old, new)] of a normalizer spec."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [step for sub in spec["normalizers"] for step in _normalizers(sub)]
    if kind == "Prepend":
        return [("prepend", spec["prepend"])]
    if kind == "Replace" and set(spec["pattern"]) == {"String"}:
        return [("replace", spec["pattern"]["String"], spec["content"])]
    _refuse("normalizer", kind if kind != "Replace" else f"Replace {spec['pattern']}")


def _template(spec) -> List:
    """The single-sequence template of a ``TemplateProcessing`` spec: a list
    of token ids and None (the text's ids)."""
    if spec is None:
        return [None]
    if spec.get("type") != "TemplateProcessing":
        _refuse("post-processor", spec.get("type"))
    out = []
    for item in spec["single"]:
        if "Sequence" in item:
            out.append(None)
        else:
            out.extend(spec["special_tokens"][item["SpecialToken"]["id"]]["ids"])
    return out


class HFBPETokenizer:
    """A ``tokenizer.json`` BPE tokenizer under its directory's
    ``tokenizer_config.json`` (``tokenizer_class``, special tokens,
    ``padding_side``, ``add_bos_token``/``add_eos_token``)."""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 model_type: Optional[str] = None):
        config = dict(config or {})
        model = spec["model"]
        if model.get("type") != "BPE":
            _refuse("model", model.get("type"))
        if spec.get("pre_tokenizer") is not None:
            _refuse("pre-tokenizer", spec["pre_tokenizer"].get("type"))
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                _refuse(f"BPE {key}", model[key])
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.merges: Dict[tuple, tuple] = {}
        for rank, merge in enumerate(model["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.unk_token = model.get("unk_token")
        self.normalizers = _normalizers(spec.get("normalizer"))

        self.added: Dict[str, int] = {}
        for tok in spec.get("added_tokens", []):
            for flag in _ADDED_TOKEN_FLAGS:
                if tok.get(flag):
                    _refuse(f"added token {tok['content']!r} with {flag}", True)
            self.added[tok["content"]] = tok["id"]
        # the special tokens the tokenizer files name join the added tokens,
        # at their vocabulary id or the next free one (add_special_tokens)
        self.special = {k: config.get(k) for k in ("bos_token", "eos_token", "unk_token",
                                                    "pad_token")}
        names = [v for v in self.special.values() if v is not None]
        names += list(config.get("additional_special_tokens") or [])
        for name in names:
            if name in self.added:
                continue
            if name in self.vocab:
                self.added[name] = self.vocab[name]
            else:  # AddedVocabulary::add_tokens' next id
                top = max(self.added.values(), default=-1)
                self.added[name] = top + 1 if top >= len(self.vocab) else len(self.vocab)
        self._added_re = (re.compile("(" + "|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)) + ")")
            if self.added else None)

        cls = config.get("tokenizer_class") or _CLASS_OF_MODEL_TYPE.get(model_type or "", "")
        cls = cls[: -len("Fast")] if cls.endswith("Fast") else cls
        self.padding_side = config.get("padding_side") or (
            "left" if cls in _LLAMA_CLASSES else "right")
        if cls in _LLAMA_CLASSES:
            bos = self.special["bos_token"] if "bos_token" in config else "<s>"
            eos = self.special["eos_token"] if "eos_token" in config else "</s>"
            add_bos, add_eos = config.get("add_bos_token", True), config.get("add_eos_token", False)
            if config.get("add_prefix_space") is not None:
                _refuse("add_prefix_space (a conversion from the slow tokenizer)",
                        config["add_prefix_space"])
            if (add_bos and bos is None) or (add_eos and eos is None):
                raise ValueError("add_bos_token/add_eos_token set without the token")
            self.template = (([self.token_id(bos)] if add_bos else []) + [None]
                             + ([self.token_id(eos)] if add_eos else []))
        else:
            self.template = _template(spec.get("post_processor"))
        pad = self.special["pad_token"]
        self.pad_id = None if pad is None else self.token_id(pad)

    @classmethod
    def from_dir(cls, path) -> "HFBPETokenizer":
        """The tokenizer of the directory ``path``: ``tokenizer.json`` under
        its ``tokenizer_config.json`` and ``special_tokens_map.json`` (and
        ``config.json``'s model_type where they name no class)."""
        d = Path(path)
        model_type = read_config(d).get("model_type") if (d / "config.json").is_file() else None
        return cls(read_json(d / "tokenizer.json"), read_tokenizer_config(d), model_type)

    # ------------------------------------------------------------------
    def token_id(self, token: str) -> int:
        if token in self.added:
            return self.added[token]
        if token in self.vocab:
            return self.vocab[token]
        return self.vocab[self.unk_token]

    def _normalize(self, text: str) -> str:
        for step in self.normalizers:
            if step[0] == "prepend":
                text = step[1] + text if text else text
            else:
                text = text.replace(step[1], step[2])
        return text

    def _symbols(self, word: str) -> List[int]:
        """The word's symbols before any merge (``BPE::merge_word``)."""
        out, unk = [], None  # unk: a pending run of unknown characters
        for ch in word:
            if ch in self.vocab:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(self.vocab[ch])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in ch.encode("utf-8")]
                if all(c in self.vocab for c in codes):
                    out.extend(self.vocab[c] for c in codes)
                    continue
            if self.unk_token is not None:
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = self.vocab[self.unk_token]
        if unk is not None:
            out.append(unk)
        return out

    def _bpe(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        sym = self._symbols(word)
        n = len(sym)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        queue = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                queue.append((m[0], i, m[1]))
        heapq.heapify(queue)
        while queue:
            _, pos, new_id = heapq.heappop(queue)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:  # an entry the queue outlived
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] != -1:
                prv[nxt[pos]] = pos
            for a, b in ((prv[pos], pos), (pos, nxt[pos])):
                if a != -1 and b != -1:
                    m = self.merges.get((sym[a], sym[b]))
                    if m is not None:
                        heapq.heappush(queue, (m[0], a, m[1]))
        return [s for s, keep in zip(sym, alive) if keep]

    def tokenize_ids(self, text: str) -> List[int]:
        """The text's ids before the template."""
        parts = self._added_re.split(text) if self._added_re else [text]
        ids = []
        for i, part in enumerate(parts):
            if i % 2:
                ids.append(self.added[part])
            elif part:
                word = self._normalize(part)
                if word:
                    ids.extend(self._bpe(word))
        return ids

    def encode(self, text: str) -> List[int]:
        ids = self.tokenize_ids(text)
        out = []
        for item in self.template:
            if item is None:
                out.extend(ids)
            else:
                out.append(item)
        return out

    def __call__(self, texts: Sequence[str], padding: str = "longest",
                 max_length: Optional[int] = None, truncation: bool = False
                 ) -> Dict[str, np.ndarray]:
        """The batch of ``tokenizer(texts, padding=...)``: ``input_ids`` and
        ``attention_mask``, int64, padded on ``padding_side``. Without a pad
        token it raises ``ValueError``, as ``transformers`` does."""
        if truncation:
            raise NotImplementedError("HFBPETokenizer: truncation (no caller asks for it)")
        return pad_batch([self.encode(t) for t in texts], self.pad_id, padding, max_length,
                         self.padding_side)
