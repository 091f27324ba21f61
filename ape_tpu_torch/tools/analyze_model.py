"""Parameters, forward FLOPs and structure of a config's model (counterpart
of ``tools/analyze_model.py``), built by the port's ``LazyConfig`` and
``model_zoo.build_model``:

    python3 -m ape_tpu_torch.tools.analyze_model --config-file <config>
        [--tasks parameter,flop,structure] [--image-size N] [--device cpu]
        [key=value ...]

On the CUDA card unless ``--device cpu``. ``parameter``: the total and the
count of each top-level module (the reference names, which the JAX tree's
top-level names carry over into). ``flop``: the f32 forward's GFLOPs on one
zero image of ``--image-size`` (default ``train.image_size``, else 1024)
with ``train.num_text`` zero text features of width ``train.text_dim``, as
JAX's tool feeds it, counted by ``FlopCounterMode``
(``tools.flops_report.count_flops``: matmuls, convolutions and the hand
kernels' registered formulas; JAX's XLA cost analysis also counts
elementwise work and bytes, which this count does not). ``structure``: the
module tree.
"""

from __future__ import annotations

import argparse
from collections import Counter

import torch

from ape_tpu_torch.config import LazyConfig
from ape_tpu_torch.device import default_device
from ape_tpu_torch.model_zoo.model_zoo import build_model
from ape_tpu_torch.tools.flops_report import count_flops


def parameter_counts(model: torch.nn.Module):
    """(total, {top-level module: parameters})."""
    by_top = Counter()
    for name, p in model.named_parameters():
        by_top[name.split(".")[0]] += p.numel()
    return sum(by_top.values()), dict(by_top)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--tasks", default="parameter,flop", help="parameter,flop,structure")
    p.add_argument("--image-size", type=int, default=0, help="override train.image_size")
    p.add_argument("--device", default=None, help="cpu; default: the CUDA card")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    cfg = LazyConfig.load(args.config_file)
    LazyConfig.apply_overrides(cfg, [o for o in (args.opts or []) if "=" in o])
    device = torch.device(default_device("analyze_model", args.device))
    model = build_model(cfg, device=device).eval()
    train = cfg.get("train", {})
    img = args.image_size or int(train.get("image_size", 1024))
    num_text = int(train.get("num_text", 80))
    text_dim = int(train.get("text_dim", 1024))
    tasks = args.tasks.split(",")
    out = {"image_size": img}

    if "parameter" in tasks:
        total, by_top = parameter_counts(model)
        print(f"#parameters: {total / 1e6:.2f}M")
        for k, v in sorted(by_top.items(), key=lambda kv: -kv[1]):
            print(f"  {k:30s} {v / 1e6:8.2f}M")
        out.update(parameters=total, parameters_by_module=by_top)

    if "flop" in tasks:
        x = (torch.zeros(1, img, img, 3, device=device), torch.tensor([[img, img]], device=device),
             torch.zeros(1, num_text, text_dim, device=device),
             torch.ones(1, num_text, dtype=torch.bool, device=device))

        def forward():
            with torch.no_grad():
                model(*x)

        flops, by_op = count_flops(forward)
        print(f"forward GFLOPs @ {img}x{img}: {flops / 1e9:.1f}")
        out.update(flops=flops, flops_by_op=by_op)

    if "structure" in tasks:
        print(model)
    return out


if __name__ == "__main__":
    main()
