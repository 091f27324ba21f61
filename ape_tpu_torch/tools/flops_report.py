"""FLOPs and MFU of the benchmark configurations (counterpart of
``tools/flops_report.py``): the forward that ``bench.py`` times (protocol, or
the full masked model) or the train step that ``tools/bench_train.py`` times,
built as JAX's ``build_forward`` and ``build_train`` build them, counted by
``torch.utils.flop_counter.FlopCounterMode`` over one call:

    python3 -m ape_tpu_torch.tools.flops_report [--model ti|l_d]
        [--mode protocol|full|train] [--img 1024] [--num-text N] [--batch 2]
        [--img-per-s X] [--no-save] [--device cpu]

On the CUDA card unless ``--device cpu``. FlopCounterMode counts matmuls
and convolutions by PyTorch's formulas and the port's hand kernels, which it
cannot see inside (a ``ctypes`` launch, a gather), by the formulas their
operators register: ``ops.msda_dispatch.msda_flops`` (K1, its window entry,
K8, K9; K2 or K3 + K4) and ``ops.attention.attn_flops`` (K5, K5-dq,
K5-dkv). The CPU runs the plain versions through the same operators, so one
model, mode and batch count the same on the card and on the CPU. Elementwise
work is not counted (XLA's cost analysis counts it: JAX's figures are
larger), and XLA's "bytes accessed" has no FlopCounterMode counterpart, so
the record has no HBM bytes and no HBM floor.

Prints one JSON line: the parameters, GFLOPs per image and by operator, and
the compute floor per image against an H100 SXM's dense peak for the run's
dtype (bf16 989 TFLOP/s for the forwards, f32 67 TFLOP/s for the f32 train
step, as JAX's ``build_train`` runs it); with ``--img-per-s`` the MFU. Saves
it under "{model}-{mode}" in ``FLOPS_TORCH.json`` at the root of the checkout
(JAX's tool writes ``FLOPS.json``) unless ``--no-save``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ape_tpu_torch.device import default_device

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
OUT = Path(__file__).resolve().parents[2] / "FLOPS_TORCH.json"
SEED = 0


def count_flops(fn):
    """(total FLOPs, {operator name: FLOPs}) of one call of ``fn``."""
    with FlopCounterMode(display=False) as counter:
        fn()
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return int(counter.get_total_flops()), by_op


def seed_weights(model, seed: int = SEED):
    """Every parameter N(0, 0.02) from a CPU generator, as JAX's builders
    draw theirs, so that the card's and the CPU's builds hold the same
    weights."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def _build(model_name: str, device, **kw):
    from ape_tpu_torch.modeling.build import build_ape_l_d, build_ape_ti

    if model_name == "ti":
        return build_ape_ti(device=device, **kw)
    if model_name == "l_d":
        kw.pop("img_size")
        return build_ape_l_d(device=device, **kw)
    raise SystemExit(f"unknown model {model_name}")


def build_forward(model_name: str, mode: str, img: int, num_text: int, device,
                  dtype=torch.bfloat16):
    """(call, images a call, model): the bf16 forward of bench.py, protocol or full
    (the masked model on the 4-scale pyramid), 900 queries, radius 4; APE-L_D
    without recompute or drop path."""
    full = mode != "protocol"
    kw = dict(img_size=img, num_queries=900, window_radius=4, mask_on=full, dtype=dtype,
              scale_factors=(4.0, 2.0, 1.0, 0.5) if full else (2.0, 1.0, 0.5))
    if model_name == "l_d":
        kw.update(use_act_checkpoint=False, drop_path_rate=0.0)
    model = seed_weights(_build(model_name, device, **kw)).eval()
    rng = np.random.RandomState(SEED)
    inputs = (torch.from_numpy(rng.randn(1, img, img, 3).astype(np.float32)),
              torch.tensor([[img, img]]),
              torch.from_numpy(rng.randn(1, num_text, 1024).astype(np.float32)),
              torch.ones(1, num_text, dtype=torch.bool))
    inputs = tuple(t.to(device) for t in inputs)

    def call():
        with torch.no_grad():
            model(*inputs)

    return call, 1, model


def build_train(model_name: str, img: int, num_text: int, batch: int, device):
    """(call, images a call, model): one f32 train step of the full masked model,
    300 queries, recompute at 1024^2 and up, the losses class, boxes and
    masks, AdamW with the clip, as JAX's ``build_train``; a seeded batch of
    8 target slots, 4 valid, boxes in [0.2, 0.6), masks rand > 0.7."""
    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict

    model = seed_weights(_build(model_name, device, img_size=img, num_queries=300,
                                window_radius=4, use_act_checkpoint=img >= 1024))
    optimizer, scheduler = build_optimizer(model, vit_num_layers=24 if model_name == "l_d" else 12)
    crit = DeformableCriterion(num_classes=num_text, weight_dict=default_weight_dict(),
                               num_queries=300, losses=("class", "boxes", "masks"))
    step = make_train_step(model, crit, optimizer, scheduler)
    rng = np.random.RandomState(SEED)
    b = batch
    data = {
        "images": torch.from_numpy(rng.randn(b, img, img, 3).astype(np.float32)),
        "image_sizes": torch.tensor([[img, img]] * b),
        "text_features": torch.from_numpy(rng.randn(b, num_text, 1024).astype(np.float32)),
        "text_valid": torch.ones(b, num_text, dtype=torch.bool),
        "targets": {
            "labels": torch.from_numpy(rng.randint(0, num_text, (b, 8))).long(),
            "boxes": torch.from_numpy(rng.uniform(0.2, 0.6, (b, 8, 4)).astype(np.float32)),
            "valid": torch.from_numpy(np.broadcast_to(np.arange(8)[None] < 4, (b, 8)).copy()),
            "masks": torch.from_numpy(rng.rand(b, 8, img // 4, img // 4) > 0.7),
        },
    }

    def to(x):
        return {k: to(v) for k, v in x.items()} if isinstance(x, dict) else x.to(device)

    data = to(data)
    gen = torch.Generator(device=device).manual_seed(SEED)
    return (lambda: step(data, gen)), b, model


def report(model: str = "ti", mode: str = "protocol", img: int = 1024, num_text: int = 0,
           batch: int = 2, img_per_s: float = 0.0, device=None) -> dict:
    """The record of one configuration (module docstring)."""
    device = torch.device(default_device("flops_report", device))
    num_text = num_text or (1203 if model == "l_d" else 80)
    if mode == "train":
        dtype = torch.float32
        call, images, net = build_train(model, img, num_text, batch, device)
    else:
        dtype = torch.bfloat16
        call, images, net = build_forward(model, mode, img, num_text, device, dtype)
    flops, by_op = count_flops(call)
    per_img = flops / images
    rec = {"model": model, "mode": mode, "img": img, "num_text": num_text,
           "batch": images, "device": device.type, "dtype": str(dtype).removeprefix("torch."),
           "params": sum(p.numel() for p in net.parameters()),
           "flops": flops, "gflops_per_img": per_img / 1e9,
           "gflops_per_img_by_op": {k: v / images / 1e9 for k, v in sorted(by_op.items())},
           "peak_tflops": PEAK_FLOPS[dtype] / 1e12,
           "compute_floor_ms": per_img / PEAK_FLOPS[dtype] * 1e3}
    if img_per_s > 0:
        rec["img_per_s"] = img_per_s
        rec["mfu_pct"] = 100 * per_img * img_per_s / PEAK_FLOPS[dtype]
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["ti", "l_d"], default="ti")
    p.add_argument("--mode", choices=["protocol", "full", "train"], default="protocol")
    p.add_argument("--img", type=int, default=1024)
    p.add_argument("--num-text", type=int, default=0, help="default: 80 ti / 1203 l_d")
    p.add_argument("--batch", type=int, default=2, help="train-mode batch")
    p.add_argument("--img-per-s", type=float, default=0.0, help="measured, for MFU")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--device", default=None, help="cpu; default: the CUDA card")
    args = p.parse_args(argv)
    rec = report(args.model, args.mode, args.img, args.num_text, args.batch, args.img_per_s,
                 args.device)
    print(json.dumps(rec), flush=True)
    if not args.no_save:
        db = json.loads(OUT.read_text()) if OUT.exists() else {}
        db[f"{args.model}-{args.mode}"] = rec
        with open(OUT, "w") as f:
            json.dump(db, f, indent=1, sort_keys=True)
            f.write("\n")
    return rec


if __name__ == "__main__":
    main()
