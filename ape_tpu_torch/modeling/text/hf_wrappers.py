"""The frozen BERT, T5 and Llama-2 language towers behind ``forward_text``
(counterpart of ``ape_tpu/modeling/text/hf_wrappers.py``), read from Hugging
Face directories without ``transformers`` (``hf_files``, ``wordpiece``,
``bpe``; the towers: ``bert``, ``t5``, ``llama``).

JAX's contract, per family:

* ``Bert``: ``max_length=256`` "max_length" padding with truncation, chunks of
  500 texts, ``end_token_idx = input_ids.argmin(-1) - 1``; returns
  {last_hidden_state, attention_mask, end_token_idx, last_hidden_state_eot}.
* ``T5``: the encoder only, "longest" padding, chunks of 500; returns the
  POOLED feature (the masked average), not a dict.
* ``Llama2``: "longest" padding on the tokenizer's side, chunks of 128, the
  final hidden state with NaN and inf scrubbed to 0 before pooling;
  returns {last_hidden_state, attention_mask, last_hidden_state_eot}.

``last_hidden_state_eot`` is the masked average (``agg_lang_feat``). The
weights stay in f32 whatever the checkpoint's dtype, as JAX's
``from_pretrained`` loads them; the outputs are tensors on the tower's
device, which is the CUDA card unless the caller passes ``device="cpu"``.
A per-text-list cache returns the same object.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import torch

from ape_tpu_torch.device import default_device
from ape_tpu_torch.modeling.text import hf_files
from ape_tpu_torch.modeling.text.bert import BertModel
from ape_tpu_torch.modeling.text.bpe import HFBPETokenizer
from ape_tpu_torch.modeling.text.llama import LlamaModel
from ape_tpu_torch.modeling.text.t5 import T5Encoder
from ape_tpu_torch.modeling.text.wordpiece import WordPieceTokenizer

TOWERS = {"bert": BertModel, "t5": T5Encoder, "llama2": LlamaModel}


def agg_lang_feat(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked average over the sequence axis: hidden (N, L, C), mask (N, L)."""
    m = mask.bool()
    return (hidden * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp(min=1)


def init_tower(model: torch.nn.Module, seed: int, std: float = 0.02) -> torch.nn.Module:
    """Seeded weights as ``transformers`` initialises these towers: every
    matrix and embedding N(0, std) from a generator on the model's device,
    biases 0, norm weights 1 (in ``named_parameters`` order)."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=gen)
    return model


def build_tower(kind: str, config: dict, device, seed=None) -> torch.nn.Module:
    """The ``kind`` tower of ``config`` (a ``config.json``'s dict) in f32 on
    ``device``, built without drawing weights; with ``seed``, ``init_tower``
    draws them, else they are left for a checkpoint to fill."""
    with torch.device("meta"):
        model = TOWERS[kind](config)
    model = model.to_empty(device=device)
    if seed is not None:
        init_tower(model, seed)
    return model.eval().requires_grad_(False)


def load_tower(kind: str, path, device) -> torch.nn.Module:
    """The ``kind`` tower of the directory ``path``: its ``config.json``,
    then its weights copied in one at a time (``hf_files.load_state``: a
    missing weight raises)."""
    config = hf_files.read_config(path)
    want = hf_files.MODEL_TYPES[kind]
    if config.get("model_type", want) != want:
        raise ValueError(f"{path}: model_type {config['model_type']!r}, a {kind} tower "
                         f"reads {want!r}")
    model = build_tower(kind, config, device)
    hf_files.load_state(model, hf_files.iter_checkpoint(path), kind)
    return model


def load_tokenizer(kind: str, path):
    """BERT's WordPiece from ``vocab.txt``; T5's and Llama-2's from
    ``tokenizer.json`` (``bpe``, which refuses any model but BPE)."""
    if kind == "bert":
        return WordPieceTokenizer.from_dir(path)
    if not (Path(path) / "tokenizer.json").is_file():
        raise NotImplementedError(f"{path}: no tokenizer.json (a sentencepiece model alone is "
                                  "not read)")
    return HFBPETokenizer.from_dir(path)


class _FrozenHF:
    """Shared loading, freezing and caching. ``model`` and ``tokenizer`` may
    be passed directly (the port's modules); otherwise they load from
    ``model_name_or_path``."""

    kind = ""  # the tower kind, set by each subclass with its max_batch_size

    def __init__(self, model_name_or_path: str = "", model=None, tokenizer=None, device=None):
        device = torch.device(default_device(type(self).__name__, device))
        if (model is None or tokenizer is None) and not model_name_or_path:
            raise ValueError(f"{type(self).__name__}: pass model_name_or_path, or model and "
                             "tokenizer")
        if tokenizer is None:
            tokenizer = load_tokenizer(self.kind, model_name_or_path)
        if model is None:
            model = load_tower(self.kind, model_name_or_path, device)
        self.device = device
        self.tokenizer = tokenizer
        self.model = model.to(device).eval().requires_grad_(False)
        self._cache: Dict[tuple, object] = {}

    @torch.no_grad()
    def _encode(self, toks) -> tuple:
        """(hidden, input_ids, attention_mask) on the device, the model run
        on chunks of ``max_batch_size`` rows."""
        ids = torch.from_numpy(toks["input_ids"]).to(self.device)
        mask = torch.from_numpy(toks["attention_mask"]).to(self.device)
        chunk = self.max_batch_size
        hidden = torch.cat([self.model(ids[i:i + chunk], mask[i:i + chunk])
                            for i in range(0, ids.shape[0], chunk)])
        return hidden, ids, mask.bool()


class Bert(_FrozenHF):
    """``BertModel`` without the pooling layer."""

    kind = "bert"
    max_length = 256
    max_batch_size = 500

    def forward_text(self, text_list: List[str], cache: bool = False) -> Dict:
        key = tuple(text_list)
        if cache and key in self._cache:
            return self._cache[key]
        toks = self.tokenizer(list(text_list), max_length=self.max_length, padding="max_length",
                              truncation=True)
        hidden, ids, mask = self._encode(toks)
        ret = {
            "last_hidden_state": hidden,
            "attention_mask": mask,
            # the position of the first pad token minus one (BERT's pad id 0)
            "end_token_idx": ids.argmin(-1) - 1,
            "last_hidden_state_eot": agg_lang_feat(hidden, mask),
        }
        if cache:
            self._cache[key] = ret
        return ret


class T5(_FrozenHF):
    """The T5 encoder; ``forward_text`` returns the pooled feature (N, C)."""

    kind = "t5"
    max_batch_size = 500

    def forward_text(self, text_list: List[str], cache: bool = False) -> torch.Tensor:
        key = tuple(text_list)
        if cache and key in self._cache:
            return self._cache[key]
        hidden, _, mask = self._encode(self.tokenizer(list(text_list), padding="longest"))
        feature = agg_lang_feat(hidden, mask)
        if cache:
            self._cache[key] = feature
        return feature


class Llama2(_FrozenHF):
    """``LlamaModel``'s last hidden state with NaN and inf scrubbed."""

    kind = "llama2"
    max_batch_size = 128

    def forward_text(self, text_list: List[str], cache: bool = False) -> Dict:
        key = tuple(text_list)
        if cache and key in self._cache:
            return self._cache[key]
        hidden, _, mask = self._encode(self.tokenizer(list(text_list), padding="longest"))
        hidden = torch.nan_to_num(hidden, nan=0.0, posinf=0.0, neginf=0.0)
        ret = {
            "last_hidden_state": hidden,
            "attention_mask": mask,
            "last_hidden_state_eot": agg_lang_feat(hidden, mask),
        }
        if cache:
            self._cache[key] = ret
        return ret


def build_hf_text_model(kind: str, model_name_or_path: str = "", **kw):
    """Config-friendly factory: ``kind`` in {bert, t5, llama2}; ``kw``: the
    wrapper's ``model``, ``tokenizer`` and ``device``."""
    classes = {"bert": Bert, "t5": T5, "llama2": Llama2}
    if kind not in classes:
        raise KeyError(f"language kind {kind!r}: one of {sorted(classes)} or 'eva02clip'")
    return classes[kind](model_name_or_path, **kw)
