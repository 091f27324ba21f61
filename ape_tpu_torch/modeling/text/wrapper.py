"""The text encoder behind APE's prompts (counterpart of
``ape_tpu/modeling/text/wrapper.py``): tokenize (context 77), encode in
chunks of ``max_batch_size`` prompts, and return the reference's dict
(``last_hidden_state``, ``last_hidden_state_eot``, ``attention_mask``,
``end_token_idx``), kept in a host cache keyed on the text tuple when asked.
The tower is frozen: it runs under ``torch.no_grad`` in f32, JAX's default.

The tower lies on the CUDA card unless the caller passes ``device="cpu"``;
with no card it raises rather than fall back to the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ape_tpu_torch.device import default_device
from ape_tpu_torch.modeling.text.clip_text import CLIPTextTransformer
from ape_tpu_torch.modeling.text.tokenizer import get_tokenizer


class EVA02CLIP:
    """The frozen EVA-CLIP text tower with its tokenizer and a host cache.
    state_dict: the tower's weights (``language_state_dict_from_jax`` turns
    JAX's into them); without one the weights are random from ``rng_seed``."""

    def __init__(
        self,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        rng_seed: int = 0,
        vocab_size: int = 49408,
        context_length: int = 77,
        width: int = 1024,
        heads: int = 16,
        layers: int = 24,
        output_dim: int = 1024,
        bpe_path: Optional[str] = None,
        max_batch_size: int = 256,
        device=None,
    ):
        device = default_device("EVA02CLIP", device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.model = CLIPTextTransformer(vocab_size, context_length, width, heads, layers,
                                             output_dim)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model = self.model.to(device).eval().requires_grad_(False)
        self.device = torch.device(device)
        self.context_length = context_length
        self.tokenizer = get_tokenizer(bpe_path)
        self.max_batch_size = max_batch_size
        self._cache: Dict[tuple, Dict] = {}

    @torch.no_grad()
    def forward_text(self, text_list: List[str], cache: bool = False) -> Dict:
        key = tuple(text_list)
        if cache and key in self._cache:
            return self._cache[key]
        tokens = np.asarray(self.tokenizer(list(text_list), self.context_length))
        n = tokens.shape[0]
        bs = self.max_batch_size
        # chunks of bs rows; the last one padded with rows that hold only the
        # first row's start token, as JAX pads them to one executable shape
        n_pad = -(-max(n, 1) // bs) * bs
        tokens_p = np.zeros((n_pad, self.context_length), np.int64)
        tokens_p[:n] = tokens
        tokens_p[n:, 0] = tokens_p[:1, 0] if n else 0
        tokens_p = torch.from_numpy(tokens_p).to(self.device)
        eots, seqs = [], []
        for i in range(0, n_pad, bs):
            eot, seq = self.model(tokens_p[i : i + bs])
            eots.append(eot)
            seqs.append(seq)
        end_token_idx = torch.from_numpy(tokens.argmax(-1) if n else np.zeros(0, np.int64))
        end_token_idx = end_token_idx.to(self.device)
        ret = {
            "end_token_idx": end_token_idx,
            "attention_mask": (torch.arange(self.context_length, device=self.device)[None, :]
                               <= end_token_idx[:, None]),
            "last_hidden_state": torch.cat(seqs)[:n],
            "last_hidden_state_eot": torch.cat(eots)[:n],
        }
        if cache:
            self._cache[key] = ret
        return ret

    def encode_text(self, text_list: List[str], cache: bool = False) -> Dict:
        """The reference's encode_text: the end-of-text features only."""
        return {"last_hidden_state_eot": self.forward_text(text_list, cache)["last_hidden_state_eot"]}


def reduce_language_feature(features: torch.Tensor, mask: torch.Tensor,
                            reduce_type: str = "average") -> torch.Tensor:
    """Pool per-token features (..., N, C) under mask (..., N) to one vector
    (reference ape/modeling/text/utils.py:11-32)."""
    if reduce_type == "average":
        m = mask.to(features.dtype)[..., None]
        return (features * m).sum(-2) / m.sum(-2).clamp(min=1.0)
    if reduce_type == "max":
        return features.masked_fill(~mask[..., None], -torch.inf).amax(-2)
    if reduce_type == "last":
        # an empty mask takes the last token, as JAX's index -1 does
        idx = (mask.long().sum(-1) - 1) % features.shape[-2]
        return features.gather(-2, idx[..., None, None].expand(*idx.shape, 1,
                                                               features.shape[-1]))[..., 0, :]
    raise ValueError(reduce_type)
