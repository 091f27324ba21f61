"""Llama-2's tokenizer: the ``BPE`` model of a ``tokenizer.json`` under
the shared pipeline (``hf_pipeline``: added tokens, ``Prepend("▁")`` and
``Replace(" ", "▁")``, the ``<s>`` template that ``LlamaTokenizerFast``
rebuilds from ``add_bos_token``/``add_eos_token``, padding on the left), as
``tokenizers`` encodes a piece: a symbol a character, a character out of
the vocabulary as its UTF-8 bytes ``<0x..>`` under ``byte_fallback`` or else
``unk`` (consecutive ones fused under ``fuse_unk``), then the merges applied
lowest rank first, the leftmost of equal ranks first, as ``tokenizers``'
``Word::merge_all`` takes them from its queue.

``dropout``, ``continuing_subword_prefix`` and ``end_of_word_suffix`` raise
``NotImplementedError`` naming them; nothing is approximated.
"""

from __future__ import annotations

import heapq
from typing import Dict, List

from ape_tpu_torch.modeling.text.hf_pipeline import HFTokenizer, refuse


class HFBPETokenizer(HFTokenizer):
    """A ``tokenizer.json`` BPE tokenizer under its directory's
    ``tokenizer_config.json`` (``tokenizer_class``, special tokens,
    ``padding_side``, ``add_bos_token``/``add_eos_token``)."""

    MODEL = "BPE"

    def read_model(self, model: dict) -> None:
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                refuse(f"BPE {key}", model[key])
        self.vocab.update(model["vocab"])
        self.vocab_size = len(self.vocab)
        self.merges: Dict[tuple, tuple] = {}
        for rank, merge in enumerate(model["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.unk_token = model.get("unk_token")

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

    def tokenize_word(self, word: str) -> List[int]:
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
