"""Offline surgery of an EVA checkpoint (counterpart of
``tools/eva_interpolate_patch_14to16.py``): the 14x14 patch embedding resized
bicubically to ``--new_patch``, every absolute position table resized to the
grid of ``--image_size``, and, for a checkpoint that holds a ``model``, its
keys moved under ``backbone.net.`` (the detection checkpoints' namespace).
The resizes are ``checkpoint.convert``'s ``interpolate_patch_embed`` and
``interpolate_pos_embed_np``, which ``adapt_shapes`` also applies while a
checkpoint loads; this CLI prepares a file before ``train.init_checkpoint``
points at it. Host only (NumPy and ``torch.load``/``torch.save``):

    python3 -m ape_tpu_torch.tools.eva_interpolate_patch_14to16 \\
        --input eva.pt --output eva_16.pt --image_size 1024 [--new_patch 16]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ape_tpu_torch.checkpoint.convert import interpolate_patch_embed, interpolate_pos_embed_np


def main(argv=None):
    ap = argparse.ArgumentParser(description="interpolate patch_embed kernel")
    ap.add_argument("--input", required=True, help="EVA checkpoint with 14x14 patch embed")
    ap.add_argument("--output", required=True)
    ap.add_argument("--image_size", type=int, required=True)
    ap.add_argument("--new_patch", type=int, default=16)
    args = ap.parse_args(argv)

    ckpt = torch.load(args.input, map_location="cpu", weights_only=False)
    if "module" in ckpt:
        ckpt["model"] = ckpt.pop("module")
    sd = ckpt["model"] if "model" in ckpt else ckpt
    pe_key = next(k for k in sd if k.endswith("patch_embed.proj.weight"))
    w = np.asarray(sd[pe_key])  # (out, in, kh, kw)
    w_hwio = interpolate_patch_embed(np.transpose(w, (2, 3, 1, 0)), (args.new_patch, args.new_patch))
    sd[pe_key] = torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))
    print(f"patch embed {w.shape} -> {tuple(sd[pe_key].shape)}")

    n_new = (args.image_size // args.new_patch) ** 2 + 1
    for k in [k for k in sd if k.endswith("pos_embed")]:
        pos = np.asarray(sd[k])
        if pos.shape[-2] != n_new:
            sd[k] = torch.from_numpy(interpolate_pos_embed_np(pos, n_new))
            print(f"pos embed {k}: {pos.shape} -> {tuple(sd[k].shape)}")

    if "model" in ckpt:
        for k in list(sd):
            sd["backbone.net." + k] = sd.pop(k)
    torch.save(ckpt, args.output)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
