"""Training-time text prompt routing: name / phrase / expression + feature bank
(counterpart of ``ape_tpu/engine/text_router.py``).

Capability match: DeformableDETRSegmVL.forward's prompt routing and
``features_phrase_bank`` (the reference's ape/modeling/ape_deta/
deformable_detr_segm_vl.py:166-340):

  * name: the dataset's vocabulary (get_text_list) encoded once and cached;
    GT labels already index that vocabulary.
  * phrase: one string per GT box; GT labels are RELABELED to the cumulative
    phrase index across the batch (:198-209), so each phrase becomes its own
    class; features are per-phrase EOT embeddings.
  * expression: one string per image; same relabeling, but with
    ``expression_cumulative_gt_class=False`` every image's targets collapse to
    class 0 (:219-221).
  * text feature bank (:305-332): the classification space is padded to the
    criterion's num_classes with features of RECENT phrases from the same
    dataset (persistent per-dataset buffer), giving the grounding loss real
    negatives; ``bank_reset`` pads with zeros instead.

Offline fallback: without a language tower, phrases embed via a deterministic
per-string hash RNG (SHA-1 of the string, plus the seed, into
``np.random.RandomState``), so identical strings share a vector and the
features equal JAX's. With a tower, the port's ``EVA02CLIP.forward_text``
encodes (its end-of-text features, taken to the host as f32).
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from ape_tpu_torch.data.catalog import MetadataCatalog, get_text_list

logger = logging.getLogger("ape_tpu_torch")


class TextRouter:
    def __init__(
        self,
        model_language=None,
        num_text: int = 128,
        text_dim: int = 1024,
        dataset_prompts: Optional[Sequence[str]] = None,
        dataset_names: Optional[Sequence[Sequence[str]]] = None,  # per group
        num_datasets: int = 1,
        use_bank: bool = True,
        bank_reset: bool = False,
        expression_cumulative_gt_class: bool = True,
        seed: int = 0,
    ):
        self.lang = model_language
        self.num_text = num_text
        self.text_dim = text_dim
        self.prompts = list(dataset_prompts or ["name"] * num_datasets)
        self.dataset_names = list(dataset_names or [[]] * num_datasets)
        self.use_bank = use_bank
        self.bank_reset = bank_reset
        self.expr_cumulative = expression_cumulative_gt_class
        self.bank = np.zeros((num_datasets, num_text, text_dim), np.float32)
        self._seed = seed
        self._cache: Dict[tuple, np.ndarray] = {}

    # ------------------------------------------------------------------
    def _hash_embed(self, text: str) -> np.ndarray:
        h = int.from_bytes(hashlib.sha1(text.encode()).digest()[:4], "little")
        rng = np.random.RandomState((h + self._seed) % (2**31))
        v = rng.randn(self.text_dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def encode(self, texts: List[str], cache: bool = False) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.text_dim), np.float32)
        key = tuple(texts)
        if cache and key in self._cache:
            return self._cache[key]
        if self.lang is not None:
            out = self.lang.forward_text(list(texts), cache=cache)
            feats = out["last_hidden_state_eot"]
            if hasattr(feats, "detach"):
                feats = feats.detach().float().cpu().numpy()
            feats = np.asarray(feats, np.float32)
        else:
            feats = np.stack([self._hash_embed(t) for t in texts])
        if cache:
            self._cache[key] = feats
        return feats

    # ------------------------------------------------------------------
    def _vocabulary(self, ds_id: int) -> List[str]:
        names = self.dataset_names[ds_id] if ds_id < len(self.dataset_names) else []
        vocab: List[str] = []
        for n in names if isinstance(names, (list, tuple)) else [names]:
            meta = MetadataCatalog.get(n)
            vocab += get_text_list(meta)
        return vocab

    def __call__(self, batch: Dict) -> Dict:
        ds_id = int(batch.get("dataset_id", 0))
        prompt = self.prompts[ds_id] if ds_id < len(self.prompts) else "name"
        b = batch["images"].shape[0]

        if prompt in ("phrase", "expression") and (
            batch.get("phrases") is not None or batch.get("expressions") is not None
        ):
            per_image = batch.pop("phrases", None) or batch.pop("expressions", None)
            batch.pop("expressions", None)
            valid = np.asarray(batch["targets"]["valid"])
            labels = np.array(batch["targets"]["labels"])
            texts: List[str] = []
            for i in range(b):
                strings = list(per_image[i]) if i < len(per_image) else []
                if prompt == "expression" and not self.expr_cumulative:
                    base = len(texts)
                    texts += strings
                    labels[i][valid[i]] = 0
                    continue
                n_valid = int(valid[i].sum())
                for j in range(n_valid):
                    s = strings[j] if j < len(strings) else ""
                    labels[i, j] = len(texts)
                    texts.append(s if s else "object")
            feats = self.encode(texts)
            # bank concat/truncate/update (segm_vl.py:305-332)
            ext = np.concatenate([feats, self.bank[ds_id] * (0.0 if self.bank_reset else 1.0)], 0)
            ext = ext[: self.num_text]
            if ext.shape[0] < self.num_text:
                ext = np.pad(ext, ((0, self.num_text - ext.shape[0]), (0, 0)))
            if self.use_bank and not self.bank_reset:
                self.bank[ds_id] = ext
            batch["targets"]["labels"] = labels.astype(np.int32)
            feats_pad = ext
            n_txt = self.num_text if self.use_bank else max(len(texts), 1)
            tvalid = np.zeros(self.num_text, bool)
            tvalid[:n_txt] = True
        else:
            vocab = self._vocabulary(ds_id)
            if not vocab:
                vocab = [f"class {i}" for i in range(self.num_text)]
            vocab = vocab[: self.num_text]
            feats = self.encode(vocab, cache=True)
            feats_pad = np.zeros((self.num_text, self.text_dim), np.float32)
            feats_pad[: len(vocab)] = feats
            tvalid = np.zeros(self.num_text, bool)
            tvalid[: len(vocab)] = True

        batch["text_features"] = np.broadcast_to(
            feats_pad[None], (b, self.num_text, self.text_dim)
        ).copy()
        batch["text_valid"] = np.broadcast_to(tvalid[None], (b, self.num_text)).copy()
        batch["class_valid"] = batch["text_valid"]
        return batch
