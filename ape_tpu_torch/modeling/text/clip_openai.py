"""The OpenAI-CLIP text encoder (counterpart of
``ape_tpu/modeling/text/clip_openai.py``): ``CLIPTEXT``, ``TextModel``,
``build_clip_text_encoder``, ``get_clip_embeddings``,
``build_openclip_text_encoder`` and ``get_openclip_embeddings``, which make
the class-embedding banks that ``layers.align.ZeroShotFC`` reads by encoding
``prompt + name`` strings.

The tower is ``CLIPTextTransformer`` with ``quick_gelu`` (OpenAI CLIP's only
architectural difference from the EVA-CLIP tower), frozen, in f32, on the
CUDA card unless the caller passes ``device="cpu"``. A token list longer
than the context is cut at its head with the end-of-text token forced last
(the tokenizer's rule), so the end-of-text pool stays valid. JAX pads each
batch to a power of two so that jit does not retrace; the port encodes the
batch as it is, which leaves every row's embedding as it was.

Checkpoints: ``build_clip_text_encoder`` reads a torch state dict file (a
whole CLIP model or its text tower; ``checkpoint.convert.
language_state_dict_from_torch``) and infers the tower's sizes from it.
Without a file it builds a tower with random weights from ``seed`` and
warns, as JAX does.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ape_tpu_torch.checkpoint.convert import language_state_dict_from_torch
from ape_tpu_torch.device import default_device
from ape_tpu_torch.modeling.text.clip_text import CLIPTextTransformer
from ape_tpu_torch.modeling.text.tokenizer import get_tokenizer

logger = logging.getLogger("ape_tpu_torch")


class CLIPTEXT:
    """OpenAI CLIP's text encoder: tokenize, the causal transformer, the
    end-of-text pool; the reference module's ``tokenize``, ``encode_text``
    and ``__call__``. state_dict: the tower's weights in the port's names;
    without one they are random from ``seed``."""

    def __init__(
        self,
        embed_dim: int = 512,
        context_length: int = 77,
        vocab_size: int = 49408,
        transformer_width: int = 512,
        transformer_heads: int = 8,
        transformer_layers: int = 12,
        bpe_path: Optional[str] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device=None,
    ):
        device = default_device("CLIPTEXT", device)
        self.context_length = context_length
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = CLIPTextTransformer(vocab_size, context_length, transformer_width,
                                           transformer_heads, transformer_layers, embed_dim,
                                           quick_gelu=True)
        if state_dict is not None:
            self.net.load_state_dict(state_dict, strict=True)
        self.net = self.net.to(device).eval().requires_grad_(False)
        self.device = torch.device(device)
        self._tokenizer = get_tokenizer(bpe_path)

    def tokenize(self, texts: Union[str, List[str]]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        return np.asarray(self._tokenizer(texts, self.context_length), np.int32)

    @torch.no_grad()
    def encode_text(self, tokens) -> torch.Tensor:
        """(B, ctx) token ids -> (B, embed_dim) projected end-of-text states."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        return self.net(tokens)[0]

    def __call__(self, captions: List[str]) -> torch.Tensor:
        return self.encode_text(self.tokenize(captions))


def build_clip_text_encoder(model_path: str, pretrain: bool = True, **dims) -> CLIPTEXT:
    """``CLIPTEXT`` with the weights of the torch state dict at
    ``model_path`` when there is one: the image tower and the scalars
    dropped, the sizes read off the shapes (``text_projection``,
    ``positional_embedding``, ``token_embedding``, ``ln_final``, 64-wide
    heads, the count of ``transformer.resblocks``). Of ``dims`` only
    ``bpe_path`` and ``device`` then apply; without a file all go to
    ``CLIPTEXT``."""
    if pretrain and model_path and os.path.exists(model_path):
        logger.info("Loading pretrained CLIP text tower from %s", model_path)
        sd = torch.load(model_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if "state_dict" in sd and isinstance(sd["state_dict"], dict):
            sd = sd["state_dict"]
        sd = language_state_dict_from_torch(sd)
        width = sd["ln_final.weight"].shape[0]
        return CLIPTEXT(
            embed_dim=sd["text_projection"].shape[1],
            context_length=sd["positional_embedding"].shape[0],
            vocab_size=sd["token_embedding.weight"].shape[0],
            transformer_width=width,
            transformer_heads=width // 64,
            transformer_layers=len({k.split(".")[2] for k in sd
                                    if k.startswith("transformer.resblocks")}),
            bpe_path=dims.pop("bpe_path", None),
            state_dict=sd,
            device=dims.pop("device", None),
        )
    if pretrain:
        logger.warning("CLIP checkpoint %s not found: building a CLIPTEXT with random weights "
                       "(its embeddings are not CLIP's)", model_path)
    return CLIPTEXT(**dims)


def get_clip_embeddings(text_model, vocabulary: List[str], prompt: str = "a ") -> torch.Tensor:
    """Class names -> the (N, embed_dim) bank of ``ZeroShotFC``'s online
    mode. text_model: a ``CLIPTEXT`` or a checkpoint path."""
    if isinstance(text_model, str):
        text_model = build_clip_text_encoder(text_model, pretrain=True)
    return text_model([prompt + x for x in vocabulary])


def build_openclip_text_encoder(open_clip_name: str, open_clip_model: str, device=None):
    """open_clip's text tower, whose released checkpoints share OpenAI's
    layout: (model, tokenizer). A model name without "quickgelu" takes the
    exact GELU, with the loaded weights kept."""
    enc = build_clip_text_encoder(open_clip_model, pretrain=True, device=device)
    if "quickgelu" not in open_clip_name.lower():
        for block in enc.net.transformer.resblocks:
            block.quick_gelu = False
    return enc, enc.tokenize


def get_openclip_embeddings(model, tokenizer, vocabulary, prompt="a ") -> torch.Tensor:
    """The bank of ``prompt + name`` strings; a vocabulary of more than
    10,000 names is encoded in two halves."""
    tokens = np.asarray(tokenizer([prompt + x for x in vocabulary]), np.int32)
    if len(tokens) > 10000:
        half = len(tokens) // 2
        return torch.cat([model.encode_text(tokens[:half]), model.encode_text(tokens[half:])])
    return model.encode_text(tokens)


class TextModel:
    """The CLIP / OPENCLIP router (the reference's text_encoder.py)."""

    def __init__(self, model_type: str, model_name: str, model_path: str, device=None):
        self.model_type = model_type
        self.model_name = model_name
        self.model_path = model_path
        if model_type == "CLIP":
            self.model = build_clip_text_encoder(model_path, pretrain=True, device=device)
            self.tokenizer = self.model.tokenize
        elif model_type == "OPENCLIP":
            self.model, self.tokenizer = build_openclip_text_encoder(model_name, model_path,
                                                                     device=device)
        else:
            raise ValueError(f"unknown text model_type {model_type!r}")

    def forward_text(self, text: List[str], prompt: str = "a ") -> torch.Tensor:
        if self.model_type == "CLIP":
            return get_clip_embeddings(self.model, text, prompt)
        return get_openclip_embeddings(self.model, self.tokenizer, text, prompt)
