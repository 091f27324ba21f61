"""Profile APE's bf16 forward on one CUDA card, from the root of a
checkout, in the cells below, each with N(0, 0.02) weights and the ring-init
offsets re-armed, batch 1, 900 queries, at 1024^2 unless said:

* ``protocol``: APE-Ti's protocol forward (``chip_smoke.py``'s slice phase:
  80 texts, the 3-scale pyramid, no masks);
* ``full_serve``: ``build_ape_ti()``'s defaults (the masked model on the
  4-scale pyramid), 80 texts;
* ``l_d-protocol``: APE-L_D's protocol forward (``chip_smoke.py``'s
  l_d_slice phase, bench.py's ``BENCH_MODEL=l_d``: 1203 texts, the 3-scale
  pyramid, no masks);
* ``l_d-full``: ``build_ape_l_d()``'s defaults (the masked model on the
  4-scale pyramid), 1203 texts;
* ``l-protocol``: APE-L (the non-CLIP EVA-02-L) at the protocol
  (``chip_smoke.py``'s l_slice phase: ``build_ape_l(mask_on=False,
  scale_factors=(2.0, 1.0, 0.5))``, 1203 texts);
* ``l-full``: ``build_ape_l()``'s defaults (masked, 4-scale), 1203 texts;
* ``r50-protocol``: APE-DETA R50 at the protocol (``chip_smoke.py``'s
  r50_slice phase: ``build_ape_r50(mask_on=False)``, 80 texts; its res3-res5
  and two extras make the protocol pyramid);
* ``r50-full``: ``build_ape_r50()``'s defaults (masked), 80 texts;
* ``detr-r50``: ``build_deformable_detr_r50()`` (single-stage, 300
  queries, the class bank of 80; the texts passed are not read);
* ``vit-<tree>``: each tree of ``chip_smoke.py``'s vit_slice phase
  (``VIT_SLICE``: ViTDet-L, ViTDet-B clip_openai's DETA, EVA-01-CLIP-g at
  1536, ViT-E and EVA-02-CLIP-L at 1536 with the fusion) at the protocol
  (``build_ape_vit(tree, mask_on=False, scale_factors=(2.0, 1.0, 0.5))``), at
  its own image size and texts.

    python3 -m ape_tpu_torch.tools.profile_forward [--models protocol full_serve
                                                    l_d-protocol l_d-full l-protocol l-full
                                                    r50-protocol r50-full detr-r50
                                                    vit-vitl vit-vitb_clip_openai
                                                    vit-vitg_eva01_clip_1536
                                                    vit-vite_eva02_clip_1024
                                                    vit-vitl_eva02_clip_1536]
                                                   [--iters 10]

The counterpart of ``profile_train.py`` for the forward, and of the JAX
repository's ``experiments/attrib.py``. For each model, after two warm-up
forwards, one JSON line each:

* ``forward_stages``: ``--iters`` forwards under ``torch.no_grad``, each
  timed by CUDA events at module hooks (device clock: a span includes the
  device's idle time while the host runs ahead or behind): backbone, neck,
  ``pre_encoder`` (level masks, position embeddings, flattening), encoder,
  select (the proposals and the DETA first-stage select, NMS included, up to
  the decoder), decoder, heads (the class heads), and for the masked model
  the mask head (pixel decoder and mask product); for L_D also ``fusion``,
  the sum of the encoder's 6 fusion layers' spans, a part of ``encoder``;
  the host wall time of each forward; the median and spread of each;
* ``forward_profile``: one more forward under ``torch.profiler``: its wall
  time, device busy time (the union of kernel intervals) and share of the
  wall, kernel count, launch calls, the top kernels by summed device time,
  and the port's own kernels' launches and device time (``[count, ms]``).

Then the card's nvidia-smi line. The encoder's window MSDA forward runs on
K1's window entry (``msda_dispatch.ms_deform_attn_window``); its other forms
under ``APE_MSDA_FUSED=1`` or ``APE_MSDA_V6=1``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

import chip_smoke as cs
from ape_tpu_torch.modeling.build import (
    build_ape_l,
    build_ape_l_d,
    build_ape_r50,
    build_ape_ti,
    build_ape_vit,
    build_deformable_detr_r50,
)
from ape_tpu_torch.tools.profile_train import profile_call

# the ViT trees' cells: {cell: (tree, build_ape_vit keywords, image side, texts,
# weights drawn on the card)}, as chip_smoke's vit_slice
VIT_CELLS = {f"vit-{tree}": (tree, kw, img, texts, on_card)
             for tree, kw, img, texts, _, on_card, _ in cs.VIT_SLICE}
MODELS = ("protocol", "full_serve", "l_d-protocol", "l_d-full", "l-protocol", "l-full",
          "r50-protocol", "r50-full", "detr-r50") + tuple(VIT_CELLS)


def build(name: str, dev):
    """The model of a cell, bf16, eval, with chip_smoke's weights, and the
    cell's number of texts."""
    kw = dict(num_queries=cs.QUERIES, window_radius=cs.RADIUS, dtype=torch.bfloat16, device=dev)
    if name in VIT_CELLS:
        tree, vit_kw, _, texts, on_card = VIT_CELLS[name]
        model = build_ape_vit(tree, mask_on=False, scale_factors=(2.0, 1.0, 0.5),
                              dtype=torch.bfloat16, device=dev, **vit_kw)
        return cs.init_weights(model, cs.SEED, device=dev if on_card else "cpu").eval(), texts
    if name.startswith(("r50", "detr")):
        if name == "detr-r50":
            model = build_deformable_detr_r50(window_radius=cs.RADIUS, dtype=torch.bfloat16,
                                              device=dev)
        else:
            model = build_ape_r50(mask_on=name == "r50-full", **kw)
        return cs.init_frozen_bn(cs.init_weights(model, cs.SEED), cs.SEED + 1).eval(), cs.NUM_TEXT
    if name.endswith("protocol"):
        kw.update(mask_on=False, scale_factors=(2.0, 1.0, 0.5))
    if name.startswith("l-"):
        model = build_ape_l(**{k: v for k, v in kw.items() if k not in ("num_queries",
                                                                         "window_radius")})
        return cs.init_weights(model, cs.SEED).eval(), cs.L_D_TEXT
    if name.startswith("l_d"):
        model, texts = build_ape_l_d(use_act_checkpoint=False, drop_path_rate=0.0, **kw), cs.L_D_TEXT
    else:
        model, texts = build_ape_ti(**kw), cs.NUM_TEXT
    return cs.init_weights(model, cs.SEED).eval(), texts


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def stage_hooks(model, marks: dict):
    """Hooks that record a CUDA event at the start ("<span>0") and end
    ("<span>1") of each module span; returns their handles."""
    tr = model.transformer
    spans = {"backbone": (model.backbone, model.backbone), "neck": (model.neck, model.neck),
             "encoder": (tr.encoder, tr.encoder), "decoder": (tr.decoder, tr.decoder)}
    if model.mask_on:
        spans["pixel_decoder"] = (model.lateral_conv, model.mask_conv)
    for i, layer in enumerate(tr.encoder.vl_layers or ()):
        spans[f"fusion{i}."] = (layer, layer)
    hooks = [m.register_forward_pre_hook(lambda *_, n=n: marks.__setitem__(n + "0", _event()))
             for n, (m, _) in spans.items()]
    hooks += [m.register_forward_hook(lambda *_, n=n: marks.__setitem__(n + "1", _event()))
              for n, (_, m) in spans.items()]
    return hooks


def stages(marks: dict, mask_on: bool) -> dict:
    """Stage times in ms from one forward's events: the module spans and the
    gaps between them, which hold the rest of the forward; ``fusion``, where
    the encoder fuses, is the sum of its fusion layers' spans, inside
    ``encoder``."""
    def ms(a, b):
        return marks[a].elapsed_time(marks[b])

    fusion = [ms(k, k[:-1] + "1") for k in marks if k.startswith("fusion") and k.endswith(".0")]

    out = {"backbone": ms("backbone0", "backbone1"), "neck": ms("neck0", "neck1"),
           "pre_encoder": ms("neck1", "encoder0"), "encoder": ms("encoder0", "encoder1"),
           "select": ms("encoder1", "decoder0"), "decoder": ms("decoder0", "decoder1")}
    if mask_on:
        out["heads"] = ms("decoder1", "pixel_decoder0")
        out["mask_head"] = ms("pixel_decoder0", "end")
    else:
        out["heads"] = ms("decoder1", "end")
    if fusion:
        out["fusion"] = sum(fusion)
    out["forward"] = ms("start", "end")
    return out


def summary(values) -> dict:
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def profile_model(name: str, dev, iters: int, card: str):
    model, texts = build(name, dev)
    img = VIT_CELLS[name][2] if name in VIT_CELLS else cs.IMG
    inputs = tuple(t.to(dev) for t in cs._inputs(texts, img))
    with torch.no_grad():
        for _ in range(2):
            model(*inputs)
        torch.cuda.synchronize()
        runs, walls = [], []
        for _ in range(iters):
            marks = {}
            hooks = stage_hooks(model, marks)
            t0 = time.perf_counter()
            marks["start"] = _event()
            model(*inputs)
            marks["end"] = _event()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            for h in hooks:
                h.remove()
            runs.append(stages(marks, model.mask_on))
        split = {k: summary([r[k] for r in runs]) for k in runs[0]}
        print(json.dumps({"forward_stages": {"model": name, "texts": texts, "image": img,
                                             "iters": iters,
                                             "ms": split,
                                             "wall_ms": summary(walls), "card": card}}),
              flush=True)
        prof, ours = profile_call(lambda: model(*inputs), top_n=30)
    print(json.dumps({"forward_profile": {"model": name, **prof, "port_kernels": ours,
                                          "card": card}}), flush=True)
    del model
    torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", nargs="+", choices=MODELS, default=list(MODELS))
    parser.add_argument("--iters", type=int, default=10, help="forwards timed by events")
    args = parser.parse_args()
    _, card = cs.device_phase()
    dev = torch.device("cuda", 0)
    for name in args.models:
        profile_model(name, dev, args.iters, card)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
