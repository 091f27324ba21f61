"""T5's and mT5's tokenizer: the ``Unigram`` model of a ``tokenizer.json``
under the shared pipeline (``hf_pipeline``: added tokens, the
``Precompiled`` normalizer with ``Strip`` and ``Replace``, ``Metaspace``,
the ``</s>`` template, right padding with ``<pad>``), as ``tokenizers``
encodes a piece and ``T5TokenizerFast`` a batch.

The model is the vocabulary's (piece, score) list, ``unk_id`` and
``byte_fallback``. A piece is encoded by a Viterbi pass over a trie of the
pieces (``Unigram::encode_optimized``): at each character, every piece that
starts there extends the best path that ends there, a candidate replacing
the best path at its end only when its score is strictly higher, so the
first candidate of equal score stays (shorter pieces, then earlier
starts); a character that no one-character piece covers is also reached as
``<unk>`` at the lowest score minus 10. Walking back, consecutive unknown
characters fuse into one token. A token that is not a piece (a fused run)
becomes its UTF-8 bytes ``<0xXX>`` under ``byte_fallback`` when all of them
are pieces, else ``unk_id``.
"""

from __future__ import annotations

from typing import Dict, List

from ape_tpu_torch.modeling.text.hf_pipeline import HFTokenizer, refuse

UNK_PENALTY = 10.0
_MODEL_KEYS = {"type", "unk_id", "vocab", "byte_fallback"}
_END = ""  # a trie node's key for the id of the piece that ends there


class HFUnigramTokenizer(HFTokenizer):
    """A ``tokenizer.json`` Unigram tokenizer under its directory's
    ``tokenizer_config.json``: ``from_dir(path)``, then
    ``tokenizer(texts, padding="longest")``."""

    MODEL = "Unigram"

    def read_model(self, model: dict) -> None:
        for key in set(model) - _MODEL_KEYS:
            refuse(f"Unigram {key}", model[key])
        vocab = model["vocab"]
        if not vocab:
            raise ValueError("tokenizer.json: a Unigram model with an empty vocabulary")
        self.scores = [float(score) for _, score in vocab]
        for i, (piece, _) in enumerate(vocab):  # a repeated piece keeps its last id
            self.vocab[piece] = i
        self.vocab_size = len(vocab)
        self.unk_id = model.get("unk_id")
        if self.unk_id is not None and not 0 <= self.unk_id < len(vocab):
            raise ValueError(f"tokenizer.json: unk_id {self.unk_id} outside the vocabulary")
        self.unk_token = None if self.unk_id is None else vocab[self.unk_id][0]
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.unk_score = min(self.scores) - UNK_PENALTY
        self.trie: dict = {}
        for piece, i in self.vocab.items():
            if piece:
                node = self.trie
                for c in piece:
                    node = node.setdefault(c, {})
                node[_END] = i
        self._cache: Dict[str, List[int]] = {}

    def _unk(self) -> int:
        if self.unk_id is None:
            raise ValueError("tokenizer.json: a character no piece covers, and the Unigram model "
                             "has no unk_id")
        return self.unk_id

    def segment(self, word: str) -> List[str]:
        """The word's tokens as strings (``Unigram::encode``)."""
        n = len(word)
        score = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        ids = [0] * (n + 1)
        for i in range(n):
            base = score[i]
            node, single = self.trie, False
            for j in range(i, n):
                node = node.get(word[j])
                if node is None:
                    break
                tid = node.get(_END)
                if tid is not None:
                    cand = self.scores[tid] + base
                    if start[j + 1] < 0 or cand > score[j + 1]:
                        score[j + 1], start[j + 1], ids[j + 1] = cand, i, tid
                    single = single or j == i
            if not single:
                cand = self.unk_score + base
                if start[i + 1] < 0 or cand > score[i + 1]:
                    score[i + 1], start[i + 1], ids[i + 1] = cand, i, self._unk()
        out: List[str] = []
        unknown: List[str] = []  # a run of unknown tokens, last first
        end = n
        while end > 0:
            s = start[end]
            if self.unk_id is not None and ids[end] == self.unk_id:
                unknown.append(word[s:end])
            else:
                if unknown:
                    out.append("".join(reversed(unknown)))
                    unknown = []
                out.append(word[s:end])
            end = s
        if unknown:
            out.append("".join(reversed(unknown)))
        return out[::-1]

    def tokenize_word(self, word: str) -> List[int]:
        if word in self._cache:
            return self._cache[word]
        out: List[int] = []
        for tok in self.segment(word):
            tid = self.vocab.get(tok)
            if tid is None and self.byte_fallback:
                codes = [self.vocab.get(f"<0x{b:02X}>") for b in tok.encode("utf-8")]
                if all(c is not None for c in codes):
                    out.extend(codes)
                    continue
            out.append(self._unk() if tid is None else tid)
        self._cache[word] = out
        return out
