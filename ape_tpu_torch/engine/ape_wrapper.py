"""APE: the prompted-inference wrapper (counterpart of
``ape_tpu/engine/ape_wrapper.py``): instance, semantic and panoptic outputs.

It holds the vision model and a language model (any object with
``forward_text(text_list, cache=True)`` returning the per-text features or a
dict with ``last_hidden_state_eot``), turns a comma-separated text prompt or
the eval dataset's vocabulary into padded text features, runs the vision
model and the postprocessing of each output it is asked for: instances (with
their mask logits when the model has a mask head), per-class semantic maps
``sem_seg``, and the device half of panoptic inference ``panoptic_raw``. Dataset metadata comes in as objects
with ``name`` and ``get(key, default)``, such as the ``Metadata`` of
``ape_tpu.data.catalog``; the port imports nothing of ``ape_tpu``.

The prompt routing is JAX's (deformable_detr_segm_vl.py:342-360,
:445-448): phrase and expression prompts fuse against the text and align the
class heads to the fused text; name prompts align to the original text and
fuse against the text where the dataset is flagged in
``name_prompt_fusion_text``, else against ``name_prompt_fusion_type``'s
token ("zero" or "learnable"), or not at all ("none"). A model without
fusion layers (APE-Ti) runs the same forward for every prompt type. Per
dataset, ``select_box_nums_for_evaluation_list`` sets the box budget.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ape_tpu_torch.data.catalog import MetadataCatalog, get_text_list
from ape_tpu_torch.modeling.ape_deta.postprocess import (
    instance_inference,
    panoptic_scores,
    semantic_inference,
)


class APE:
    def __init__(
        self,
        model,  # APEDeta
        model_language,
        dataset_metadata: Sequence = (),
        dataset_names: Sequence[str] = (),
        dataset_prompts: Optional[Sequence[str]] = None,
        max_text: int = 128,
        test_score_thresh: float = 0.05,
        test_nms_thresh: float = 0.5,
        select_box_nums_for_evaluation: int = 300,
        select_box_nums_for_evaluation_list: Optional[Sequence[int]] = None,
        name_prompt_fusion_text: Optional[Sequence[bool]] = None,
        name_prompt_fusion_type: str = "zero",
        instance_on: bool = True,
        semantic_on: bool = True,
        panoptic_on: bool = False,
    ):
        self.model = model
        self.model_language = model_language
        self.metadata_list = (list(dataset_metadata)
                              + [MetadataCatalog.get(n) for n in dataset_names])
        self.dataset_prompts = list(dataset_prompts or ["name"] * len(self.metadata_list))
        self.max_text = max_text
        self.test_score_thresh = test_score_thresh
        self.test_nms_thresh = test_nms_thresh
        self.select_box_nums_default = select_box_nums_for_evaluation
        self.select_box_nums_list = (None if select_box_nums_for_evaluation_list is None
                                     else list(select_box_nums_for_evaluation_list))
        self.name_prompt_fusion_text = (None if name_prompt_fusion_text is None
                                        else list(name_prompt_fusion_text))
        self.name_prompt_fusion_type = name_prompt_fusion_type
        self.instance_on = instance_on
        self.semantic_on = semantic_on
        self.panoptic_on = panoptic_on
        self.eval_dataset_id = 0 if self.metadata_list else -1
        self._apply_dataset_protocol()
        self._text_cache: Dict[tuple, np.ndarray] = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def set_eval_dataset(self, dataset_name: str):
        """Pick the dataset whose vocabulary, prompt type, box budget and
        fusion flag apply (deformable_detr.py:524-549): an exact name wins,
        else the first whose "+"-joined name has a part inside dataset_name;
        none: -1."""
        match = -1
        for i, m in enumerate(self.metadata_list):
            if m.name == dataset_name:
                match = i
                break
            if match < 0 and any(part and part in dataset_name for part in m.name.split("+")):
                match = i
        self.eval_dataset_id = match
        self._apply_dataset_protocol()

    def _apply_dataset_protocol(self):
        """The eval dataset's box budget (deformable_detr.py:195-196)."""
        i = self.eval_dataset_id
        if self.select_box_nums_list is not None and 0 <= i < len(self.select_box_nums_list):
            self.select_box_nums = int(self.select_box_nums_list[i])
        else:
            self.select_box_nums = self.select_box_nums_default

    def fusion_mode(self, prompt_type: str) -> str:
        """What the fusion layers see for a prompt type: "text" for phrases
        and for names of a dataset flagged in name_prompt_fusion_text, else
        name_prompt_fusion_type's "zero" or "learnable" token, else "none"."""
        if prompt_type != "name":
            return "text"
        i = self.eval_dataset_id
        if (self.name_prompt_fusion_text is not None and 0 <= i < len(self.name_prompt_fusion_text)
                and self.name_prompt_fusion_text[i]):
            return "text"
        if self.name_prompt_fusion_type in ("zero", "learnable"):
            return self.name_prompt_fusion_type
        return "none"

    def _encode_vocab(self, text_list: List[str]) -> np.ndarray:
        key = tuple(text_list)
        if key not in self._text_cache:
            out = self.model_language.forward_text(text_list, cache=True)
            feats = out["last_hidden_state_eot"] if isinstance(out, dict) else out
            if isinstance(feats, torch.Tensor):
                feats = feats.detach().float().cpu().numpy()
            self._text_cache[key] = np.asarray(feats, np.float32)
        return self._text_cache[key]

    def _text_features(self, text_list: List[str]):
        """Features padded to a multiple of ``max_text``: (1, T_pad, Cl), (1, T_pad)."""
        feats = self._encode_vocab(text_list)
        t = len(text_list)
        pad = self.max_text * -(-max(t, 1) // self.max_text)
        out = np.zeros((pad, feats.shape[-1]), np.float32)
        out[:t] = feats
        valid = np.arange(pad) < t
        return (torch.from_numpy(out[None]).to(self.device),
                torch.from_numpy(valid[None]).to(self.device))

    def prompt_type(self, inp: Dict) -> str:
        """"phrase" when any comma-separated entry of the text prompt has a
        space, else "name"; without a prompt, the dataset's prompt type."""
        tp = inp.get("text_prompt")
        if tp:
            words = [w.strip() for w in tp.split(",") if w.strip()]
            return "phrase" if any(" " in w for w in words) else "name"
        if 0 <= self.eval_dataset_id < len(self.dataset_prompts):
            return self.dataset_prompts[self.eval_dataset_id]
        return "name"

    def vocabulary(self, text_prompt: Optional[str] = None) -> List[str]:
        if text_prompt:
            return [w.strip() for w in text_prompt.split(",") if w.strip()]
        if 0 <= self.eval_dataset_id < len(self.metadata_list):
            return get_text_list(self.metadata_list[self.eval_dataset_id])
        return []

    @torch.no_grad()
    def __call__(self, batched_inputs: List[Dict]) -> List[Dict]:
        """Inference on mapped inputs: ``image`` (H, W, 3) normalized and padded,
        ``image_size`` (2,) valid (h, w), optional ``text_prompt`` and ``scale``
        (input pixels per original pixel). Mask outputs need ``mask_on``:
        ``instances["mask_logits"]`` (N, Hm, Wm), ``sem_seg`` (T_pad, Hm, Wm)
        over the padded vocabulary, and ``panoptic_raw``, all at the
        mask-feature resolution of the padded input."""
        results = []
        for inp in batched_inputs:
            text_list = self.vocabulary(inp.get("text_prompt")) or ["object"]
            txt, tvalid = self._text_features(text_list)
            image = torch.as_tensor(inp["image"], device=self.device)[None]
            size = torch.as_tensor(inp["image_size"], device=self.device)
            ptype = self.prompt_type(inp)
            out = self.model(image, size[None], txt, tvalid, align_on_fused=ptype != "name",
                             fusion_text_mode=self.fusion_mode(ptype))
            masks = out["pred_masks"][0] if "pred_masks" in out else None
            res = {"image_id": inp.get("image_id", 0)}
            if self.instance_on:
                res["instances"] = self._instances(inp, out, size, tvalid[0], len(text_list), masks)
            if self.semantic_on and masks is not None:
                res["sem_seg"] = semantic_inference(out["pred_logits"][0], masks, tvalid[0])
            if self.panoptic_on and masks is not None:
                scores, labels, raw = panoptic_scores(out["pred_logits"][0], tvalid[0])
                res["panoptic_raw"] = {"scores": scores, "labels": labels, "raw_scores": raw,
                                       "mask_logits": masks}
            res.update(text_list=text_list, prompt_type=ptype)
            results.append(res)
        return results

    def _instances(self, inp, out, size, tvalid, n_text, masks):
        # with an explicit thing/stuff split the instance path sees things only
        inst_valid = tvalid
        if 0 <= self.eval_dataset_id < len(self.metadata_list) and not inp.get("text_prompt"):
            n_thing = len(self.metadata_list[self.eval_dataset_id].get("thing_classes", []) or [])
            if n_thing and n_thing < n_text:
                inst_valid = inst_valid & (torch.arange(inst_valid.shape[0], device=self.device) < n_thing)
        inst = instance_inference(
            out["pred_logits"][0], out["pred_boxes"][0], size, inst_valid,
            score_thresh=self.test_score_thresh, nms_thresh=self.test_nms_thresh,
            topk=self.select_box_nums)
        keep = inst["valid"]
        instances = {
            "boxes": inst["boxes"][keep] / inp.get("scale", 1.0),
            "scores": inst["scores"][keep],
            "classes": inst["classes"][keep],
        }
        if masks is not None:
            instances["mask_logits"] = masks[inst["query_idx"][keep]]
        return instances
