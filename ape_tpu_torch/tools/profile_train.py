"""Profile one train step on one CUDA card, from the root of a checkout: APE-Ti
in ``chip_smoke.py``'s train configuration (1024^2, batch 2, 300 queries,
bf16, recompute checkpointing), APE-L_D in its ``l_d_train`` one (batch
1, the masked model, drop path 0.4, 1203 texts, the LVIS recipe's
criterion with the federated loss, ``vit_num_layers=24``), APE-L in its
``l_train`` one (the ADE20k panoptic recipe: batch 2, masked, 900 queries,
no recompute, 150 classes in 160 text slots), the R50 family in its
``r50_train`` and ``detr_r50_train`` ones (batch 2, 300 queries, the R50
recipe's optimizer), or ViTDet-L APE-DETA in its ``vitl_train`` one (the
COCO recipe: batch 2, masked, 900 queries, no recompute, 80 classes in 96
text slots), or one of the EVA-01 ViT-g recipes built from its config file
as ``train_net`` builds it (``VITG_RECIPES``: ``vitg``, the DETA recipe at
LSJ 1024, chip_smoke's ``vitg_train``; ``vitg_1536``, EVA-01-CLIP-g's
APE-DETA recipe at LSJ 1536; batch 1 by default):

    python3 -m ape_tpu_torch.tools.profile_train [--masked]
                                                 [--model ti|l_d|l|r50|detr_r50|vitl|vitg|vitg_1536]
                                                 [--batch N]

Without flags the Ti detection model (chip_smoke's phase 8); ``--masked``
the full masked Ti model with the mask losses (phase 11); ``--model l_d``
APE-L_D (phase 13's ``l_d_train``); ``--model l`` APE-L (phase 14's
``l_train``); ``--model vitl`` ViTDet-L APE-DETA (phase 16's
``vitl_train``); ``--model r50`` APE-DETA R50 (masked,
recompute, DETA's criterion with masks); ``--model detr_r50``
Deformable-DETR R50 (no masks, the Hungarian on every layer, no
recompute); ``--batch`` another batch size. A
step that runs out of card memory prints the allocator's figures
(``out_of_memory``: allocated, reserved and peak, the card's total, the
request that failed, the error's text), then the backbone's share
(``backbone_memory``, below), and exits 1; a ViT-g recipe's step that
fits is followed by that share too. Under
``APE_MSDA_BWD_MERGED=0`` the encoder's MSDA backward runs on the split
kernels (K3 + K4) instead of K2; under ``APE_MSDA_FUSED=1`` (K8) or
``APE_MSDA_V6=1`` (K9 + K1) its forward takes another form.

Prints three JSON lines and the card's nvidia-smi line:

* ``stage_split``: three steps timed by CUDA events: forward with the loss,
  backward (recompute included), clip with the optimizer step; the
  forward of the backbone, neck, encoder (for L_D with its fusion layers,
  also apart as ``fusion``), decoder and, with a mask head, the pixel
  decoder (lateral conv to mask conv); the criterion (the model's end to
  the loss); the recompute inside the backward (the fusion, encoder and
  decoder layers' forwards there); the fusion layers' backward, their
  recompute inside it (from the gradient reaching a layer's outputs to
  the one leaving its inputs); peak memory;
* ``profile``: one step under ``torch.profiler``: device busy time (the
  union of kernel intervals) against the step's wall time, kernel and launch
  counts, and the top kernels by summed device time;
* ``kernels``: the port's own kernels' launches and summed device time in
  that step, [count, ms] by name;
* ``backbone_memory`` (after an out-of-memory step, and for a ViT-g recipe):
  the backbone alone, freshly built with the model's weights' draw, a
  forward under autograd of one batch and a backward of its pyramid's sum of
  squares, in bf16: the allocated bytes after each block's forward (what
  autograd keeps, block by block, windowed and global apart), after the
  pyramid, and the peak; a forward or backward that runs out of memory
  records how far it came and the allocator's figures.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from ape_tpu_torch.engine.optimizer import R50_RECIPE, build_optimizer
from ape_tpu_torch.engine.train_step import loss_fn, make_train_step
from ape_tpu_torch.modeling.build import (
    build_ape_l,
    build_ape_l_d,
    build_ape_r50,
    build_ape_ti,
    build_ape_vit,
    build_deformable_detr_r50,
)
from ape_tpu_torch.ops import msda_dispatch

# the ViT-g recipes by --model: their config files, which build the model,
# the criterion and the optimizer
VITG_RECIPES = {
    "vitg": cs.VITG_CONFIG,
    "vitg_1536": "configs/COCO_InstanceSegmentation/ape_deta/"
                 "ape_deta_vitg_eva01_clip_lsj1536_cp_64x90k.py",
}
PORT_KERNELS = ("msda_fwd_kernel", "msda_fwd_qlevel", "msda_fwd_dense", "msda_bwd_kernel",
                "msda_bwd_offatt", "msda_bwd_value", "attn_fwd", "attn_bwd")


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def span_hooks(spans: dict, marks: dict):
    """Forward pre- and post-hooks that record a CUDA event into ``marks``
    as ``{name}0`` and ``{name}1`` for each span (first module, last module);
    a module that runs more than once keeps its last run."""
    hooks = [m.register_forward_pre_hook(lambda *_, n=n: marks.__setitem__(n + "0", _event()))
             for n, (m, _) in spans.items()]
    hooks += [m.register_forward_hook(lambda *_, n=n: marks.__setitem__(n + "1", _event()))
              for n, (_, m) in spans.items()]
    return hooks


def timed_forwards(modules: dict, marks: dict):
    """Wrap each module's forward to record CUDA events into ``marks`` as
    ``{name}0`` and ``{name}1``: unlike hooks, this also times the forwards
    that checkpoint's recompute runs inside the backward, which stops each
    once it has what the backward needs (by an exception, hence the
    ``finally``). Returns the undo."""
    for name, m in modules.items():
        def forward(*args, _f=m.forward, _n=name, **kwargs):
            marks[_n + "0"] = _event()
            try:
                return _f(*args, **kwargs)
            finally:
                marks[_n + "1"] = _event()

        m.forward = forward
    return lambda: [delattr(m, "forward") for m in modules.values()]


def backward_spans(modules: dict, marks: dict):
    """Wrap each module's forward so that the gradients reaching its outputs
    and leaving through its inputs record CUDA events into ``marks``:
    ``{name}0`` as the last output gradient arrives, ``{name}1`` as the last
    input gradient leaves. The span is the module's backward, checkpoint's
    recompute inside it. Undo before the backward (the returned call): the
    hooks stay on the forward's tensors."""
    def mark(key):
        def hook(grad):
            marks[key] = _event()
        return hook

    for name, m in modules.items():
        def forward(*args, _f=m.forward, _n=name, **kwargs):
            out = _f(*args, **kwargs)
            for key, ts in ((_n + "0", out if isinstance(out, tuple) else (out,)),
                            (_n + "1", args)):
                for t in ts:
                    if isinstance(t, torch.Tensor) and t.requires_grad:
                        t.register_hook(mark(key))
            return out

        m.forward = forward
    return lambda: [delattr(m, "forward") for m in modules.values()]


def _summed(marks: dict, prefix: str) -> float:
    """The summed ms of every recorded span whose name starts with prefix."""
    return sum(marks[k].elapsed_time(marks[k[:-1] + "1"]) for k in marks
               if k.startswith(prefix) and k.endswith("0") and k[:-1] + "1" in marks)


def stage_split(model, crit, opt, sched, batch, gen, steps: int = 3):
    enc, dec = model.transformer.encoder, model.transformer.decoder
    spans = {"backbone": (model.backbone, model.backbone), "neck": (model.neck, model.neck),
             "encoder": (enc, enc), "decoder": (dec, dec), "model": (model, model)}
    if model.mask_on:
        spans["pixel_decoder"] = (model.lateral_conv, model.mask_conv)
    # the layers the backward recomputes (use_act_checkpoint), each a span
    layers = {f"encoder_layer{i}.": m for i, m in enumerate(enc.layers)}
    layers.update({f"decoder_layer{i}.": m for i, m in enumerate(dec.layers)})
    layers.update({f"fusion{i}.": m for i, m in enumerate(enc.vl_layers or ())})
    fusion = {n: m for n, m in layers.items() if n.startswith("fusion")}
    splits = []
    for _ in range(steps):
        marks, recompute, backward = {}, {}, {}
        hooks = span_hooks({**spans, **{n: (m, m) for n, m in fusion.items()}}, marks)
        undo = backward_spans(fusion, backward)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        ev = [_event()]
        total, _, _ = loss_fn(model, crit, batch, gen)
        ev.append(_event())
        for h in hooks:
            h.remove()
        undo()
        undo = timed_forwards(layers, recompute)
        total.backward()
        ev.append(_event())
        undo()
        torch.nn.utils.clip_grad_norm_(list(model.parameters()), 0.1)
        opt.step()
        sched.step()
        ev.append(_event())
        torch.cuda.synchronize()
        modules = {n: marks[n + "0"].elapsed_time(marks[n + "1"]) for n in spans if n != "model"}
        if enc.vl_layers is not None:
            modules["fusion"] = _summed(marks, "fusion")
        splits.append(dict(
            wall_ms=(time.perf_counter() - t0) * 1e3,
            forward_and_loss_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
            optimizer_ms=ev[2].elapsed_time(ev[3]), forward_modules_ms=modules,
            criterion_ms=marks["model1"].elapsed_time(ev[1]),
            recompute_ms={k: _summed(recompute, k) for k in ("fusion", "encoder_layer",
                                                               "decoder_layer")},
            fusion_backward_ms=_summed(backward, "fusion"),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30))
    return splits


def profile_call(fn, top_n: int = 25):
    """fn() once under torch.profiler: (its wall time, device busy time (the
    union of kernel intervals) and share of the wall, kernel and launch
    counts, the top_n kernels by summed device time; the port's own
    kernels' summed device time by PORT_KERNELS)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # device events, less the user ranges drawn on the device timeline
    # (``Optimizer.step#AdamW.step``): those span idle gaps
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_us, cur = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if cur is None or s > cur[1]:
            busy_us += 0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += 0 if cur is None else cur[1] - cur[0]
    by_name = {}
    for e in kern:
        d = by_name.setdefault(e.name[:90], [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us() / 1e3
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
                   for e in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    ours = {k: [sum(c for n, (c, _) in by_name.items() if k in n),
                sum(ms for n, (_, ms) in by_name.items() if k in n)] for k in PORT_KERNELS}
    return (dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                 busy_share_of_wall=busy_us / 1e3 / wall_ms, kernels=len(kern),
                 launch_calls=launches, top=[[n, c, ms] for n, (c, ms) in top]), ours)


def setup(model_name: str, masked: bool, batch_size, dev):
    """(model, criterion, optimizer, scheduler, batch, generator) of the
    smoke's train phase for ``model_name``."""
    if model_name == "l_d":
        model = build_ape_l_d(num_queries=cs.TRAIN_QUERIES, window_radius=cs.RADIUS,
                              dtype=torch.bfloat16, device=dev)
        crit = cs._l_d_criterion()
        opt, sched = build_optimizer(model, vit_num_layers=24, milestones=(150000, 180000),
                                     warmup_steps=2000)
        batch = cs._train_batch(dev, batch_size or cs.L_D_TRAIN_BATCH, cs.TRAIN_IMG, cs.SEED + 4,
                                masks=True, num_text=cs.L_D_TEXT)
        gen = torch.Generator().manual_seed(cs.SEED)
    elif model_name == "l":
        model = build_ape_l(dtype=torch.bfloat16, device=dev)
        crit = cs._l_criterion()
        opt, sched = build_optimizer(model, vit_num_layers=24, milestones=cs.L_MILESTONES,
                                     warmup_steps=2000)
        batch = cs._train_batch(dev, batch_size or cs.L_TRAIN_BATCH, cs.TRAIN_IMG, cs.SEED + 4,
                                masks=True, num_text=cs.L_TEXT_SLOTS, classes=cs.L_CLASSES)
        gen = torch.Generator().manual_seed(cs.SEED)
    elif model_name == "vitl":
        model = build_ape_vit("vitl", dtype=torch.bfloat16, device=dev)
        crit = cs._vitl_criterion()
        opt, sched = build_optimizer(model, vit_num_layers=24, milestones=cs.L_MILESTONES,
                                     warmup_steps=2000)
        batch = cs._train_batch(dev, batch_size or cs.VITL_TRAIN_BATCH, cs.TRAIN_IMG,
                                cs.SEED + 4, masks=True, num_text=cs.VITL_TEXT_SLOTS,
                                classes=cs.VITL_CLASSES)
        gen = torch.Generator().manual_seed(cs.SEED)
    elif model_name in VITG_RECIPES:
        from ape_tpu_torch.config import LazyConfig
        from ape_tpu_torch.model_zoo import build_criterion, build_model

        cfg = LazyConfig.load(str(cs.ROOT / VITG_RECIPES[model_name]))
        model = cs.init_weights(build_model(cfg, device=dev, dtype=torch.bfloat16), cs.SEED,
                                device=dev)
        crit = build_criterion(cfg)
        opt, sched = build_optimizer(model, **{k: v for k, v in cfg.optimizer.items()
                                               if k != "grad_clip"})
        batch = cs._train_batch(dev, batch_size or 1, int(cfg.train.image_size), cs.SEED + 4,
                                masks=model.mask_on, num_text=int(cfg.train.num_text),
                                classes=crit.num_classes)
        return model, crit, opt, sched, batch, torch.Generator().manual_seed(cs.SEED)
    elif model_name in ("r50", "detr_r50"):
        detr = model_name == "detr_r50"
        kw = dict(window_radius=cs.RADIUS, dtype=torch.bfloat16, device=dev)
        model = build_deformable_detr_r50(**kw) if detr else build_ape_r50(
            num_queries=cs.TRAIN_QUERIES, use_act_checkpoint=True, **kw)
        crit = cs._detr_criterion() if detr else cs._criterion(cs.TRAIN_QUERIES, True)
        opt, sched = build_optimizer(model, **R50_RECIPE, milestones=(
            cs.DETR_MILESTONES if detr else cs.R50_MILESTONES))
        batch = cs._train_batch(dev, batch_size or cs.TRAIN_BATCH, cs.TRAIN_IMG, cs.SEED + 4,
                                masks=not detr)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        model = cs.init_frozen_bn(model, cs.SEED + 1)
    else:
        model = build_ape_ti(num_queries=cs.TRAIN_QUERIES, window_radius=cs.RADIUS,
                             mask_on=masked, use_act_checkpoint=True, dtype=torch.bfloat16,
                             device=dev)
        crit = cs._criterion(cs.TRAIN_QUERIES, masked)
        opt, sched = build_optimizer(model)
        batch = cs._train_batch(dev, batch_size or cs.TRAIN_BATCH, cs.TRAIN_IMG, cs.SEED + 4,
                                masks=masked)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    return cs.init_weights(model, cs.SEED), crit, opt, sched, batch, gen


def allocator(error: str = "") -> dict:
    """The caching allocator's figures now, in GiB: allocated, reserved and
    the peak allocated since the last reset, the card's total; with an
    out-of-memory ``error``, the request that failed (its "Tried to
    allocate") and the error's text."""
    gib = 2**30
    rec = {"allocated_gib": torch.cuda.memory_allocated() / gib,
           "reserved_gib": torch.cuda.memory_reserved() / gib,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / gib,
           "total_gib": torch.cuda.get_device_properties(0).total_memory / gib}
    if error:
        m = re.search(r"Tried to allocate ([0-9.]+) ([GMK]i?B)", error)
        if m:
            scale = {"GiB": 1, "MiB": 2**-10, "KiB": 2**-20}.get(m[2], 1)
            rec["requested_gib"] = float(m[1]) * scale
        rec["error"] = " ".join(error.split())
    return rec


def backbone_memory(model_name: str, batch_size, dev) -> dict:
    """``setup``'s model's backbone alone (freshly built, its weights drawn as
    the model's, train mode, bf16): one forward under autograd on the
    setup's batch, recording the allocated GiB after each block's forward
    and after the pyramid, then a backward of the pyramid's sum of squares;
    the peak. Out of memory, the record says where (``stopped_in``,
    ``blocks_done``) with the allocator's figures."""
    model, _, _, _, batch, gen = setup(model_name, True, batch_size, dev)
    backbone = model.backbone.train()
    images = batch["images"].to(torch.bfloat16)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gib = 2**30
    net = backbone.net
    after = []
    hooks = [b.register_forward_hook(lambda *_: after.append(torch.cuda.memory_allocated() / gib))
             for b in net.blocks]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / gib
    rec = {"model": model_name, "batch": int(images.shape[0]), "image": int(images.shape[1]),
           "blocks": len(net.blocks), "global_blocks": [i for i, b in enumerate(net.blocks)
                                                          if b.window_size == 0],
           "params_gib": sum(p.numel() * p.element_size() for p in backbone.parameters()) / gib,
           "allocated_before_gib": base}
    stage = "forward"
    try:
        feats = backbone(images, gen)
        rec["after_forward_gib"] = torch.cuda.memory_allocated() / gib
        stage = "backward"
        sum(f.float().square().sum() for f in feats.values()).backward()
        torch.cuda.synchronize()
        rec["fits"] = True
    except torch.cuda.OutOfMemoryError as e:
        rec.update(fits=False, stopped_in=stage, **allocator(str(e)))
    for h in hooks:
        h.remove()
    kept = [a - b for a, b in zip(after, [base] + after[:-1])]
    rec.update(blocks_done=len(after), after_block_gib=after, kept_by_block_gib=kept,
               peak_gib=torch.cuda.max_memory_allocated() / gib)
    glob = set(rec["global_blocks"])
    for kind, sel in (("global", lambda i: i in glob), ("windowed", lambda i: i not in glob)):
        ks = [k for i, k in enumerate(kept) if sel(i)]
        rec[f"kept_{kind}_block_gib"] = (min(ks), max(ks)) if ks else None
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--masked", action="store_true", help="the full masked Ti model")
    parser.add_argument("--model", choices=("ti", "l_d", "l", "r50", "detr_r50", "vitl",
                                            *VITG_RECIPES),
                        default="ti",
                        help="APE-Ti, APE-L_D (masked, batch 1 by default), APE-L (masked), "
                             "APE-DETA R50 (masked), Deformable-DETR R50, ViTDet-L APE-DETA "
                             "(masked), or a ViT-g recipe (VITG_RECIPES, batch 1 by default)")
    parser.add_argument("--batch", type=int, default=None,
                        help="batch size (default: 2, 1 for L_D and the ViT-g recipes)")
    args = parser.parse_args()
    card = cs.device_phase()[1]
    dev = torch.device("cuda", 0)
    model, crit, opt, sched, batch, gen = setup(args.model, args.masked, args.batch, dev)
    step = make_train_step(model, crit, opt, sched)
    form = {"model": args.model,
            "masked": bool(args.masked or model.mask_on),
            "batch": batch["images"].shape[0], "split": not msda_dispatch.BWD_MERGED,
            "window_forward": msda_dispatch.window_form(8),
            "params": sum(p.numel() for p in model.parameters())}
    if args.model in VITG_RECIPES:
        form["config"] = VITG_RECIPES[args.model]
    torch.cuda.reset_peak_memory_stats()
    error = ""
    try:
        for _ in range(2):
            step(batch, gen)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        error = str(e)
    if error:
        print(json.dumps({"out_of_memory": {**form, **allocator(error), "card": card}}),
              flush=True)
        del model, crit, opt, sched, batch, step
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"backbone_memory": {**backbone_memory(args.model, args.batch, dev),
                                              "card": card}}), flush=True)
        sys.exit(1)
    print(json.dumps({"form": form}), flush=True)
    print(json.dumps({"stage_split": stage_split(model, crit, opt, sched, batch, gen)}), flush=True)
    prof, ours = profile_call(lambda: step(batch, gen))
    print(json.dumps({"profile": prof}), flush=True)
    print(json.dumps({"kernels": ours}), flush=True)
    if args.model in VITG_RECIPES:
        del model, crit, opt, sched, batch, step
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"backbone_memory": backbone_memory(args.model, args.batch, dev)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
