"""Sweep the global-attention kernel's tile, and time the patchify, on one
CUDA card, from the root of a checkout:

    python3 -m ape_tpu_torch.tools.backbone_fix_probe [--iters N]

The counterpart of the JAX repository's ``experiments/backbone_fix_probe.py``
at its shapes: q, k, v (1, 3, 4096, 64) bf16, the global ViT blocks' of
APE-Ti at 1024^2. It times einsum attention with an f32 softmax (the plain
version, ``global_attention_plain``) and with a bf16 softmax, K5
(``csrc/attn_fwd.cu``), K11 (``csrc/attn_fwd_tiles.cu``) at each of its
tiles, and ``F.scaled_dot_product_attention`` as the library yardstick; the
TPU probe's 1024-row blocks get a record that says they do not fit a block.
Then the patchify, (1, 3, 1024, 1024) -> (1, 64, 64, 192), as ``F.conv2d``
against the port's matmul ``PatchEmbed``, with their parity.

Each record is one JSON line: its time (CUDA events over ``iters`` calls
after a warm-up), its max |x - plain|, the bound (attention: 4 N^2 Dh flops
a head at 989 TFLOP/s, 0.013 ms; patchify: its bytes at 3.35 TB/s), and
the card's name and power limit; a tile's also carries its shared memory,
registers and spills (``-Xptxas -v``). Every tile and K5 are held against the
plain version in bf16 (four bf16 steps at the output's largest magnitude)
and, on the same draws in f32, within ``F32_BOUND``; (64, 64) against K5 bit
for bit. ``chip_smoke.py`` calls ``probe``; ``device="cpu"`` runs only the
plain versions, untimed.
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch
import torch.nn.functional as F

from ape_tpu_torch.modeling.backbone.eva_vit import PatchEmbed
from ape_tpu_torch.ops import _build
from ape_tpu_torch.ops.attention import (
    TILES,
    attn_fwd_tiles,
    attn_tile_fits,
    attn_tile_smem,
    global_attention,
    global_attention_plain,
)
from ape_tpu_torch.ops.bounds import bf16_steps
from ape_tpu_torch.tools.msda_race import HBM_BYTES_PER_S, card_line, cuda_ms
from ape_tpu_torch.tools.pair_probe import device_or_card

SEED = 0
SHAPE = (1, 3, 4096, 64)  # the global blocks' q, k, v at 1024^2
IMAGE, PATCH, EMBED = 1024, 16, 192
JAX_BLOCK = 1024  # the TPU probe's big blocks
DTYPE = torch.bfloat16
F32_BOUND = 1e-4  # |kernel - plain| in f32: sums over 4096 keys in another order
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense tensor cores


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def einsum_bf16_softmax(q, k, v, scale: float):
    """The TPU probe's ``einsum_bf16sm``: the softmax in the inputs' dtype."""
    return torch.matmul(torch.softmax(torch.matmul(q * scale, k.transpose(-1, -2)), -1), v)


def _tile_build_info():
    """{(dh, bq, bk, dname): ptxas info} of attn_fwd.cuh's instances."""
    out = {}
    for name, info in _build.ptxas_info().items():
        m = re.search(r"attn_fwd_kernelILi(\d+)ELi(\d+)ELi(\d+)E(f|13__nv_bfloat16)E", name)
        if m:
            out[(*map(int, m.groups()[:3]), "float32" if m.group(4) == "f" else "bfloat16")] = info
    return out


def probe(device=None, card: str = "", shape=SHAPE, image: int = IMAGE, iters: int = 20):
    """Time every attention form and tile at ``shape`` and the patchify at
    ``image``, in bf16, each held against its plain version. Prints each
    record as a JSON line and returns them."""
    dev = device_or_card(device)
    timed = dev.type == "cuda"
    rng = np.random.RandomState(SEED)
    q32, k32, v32 = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
                     for _ in range(3))
    q, k, v = (t.to(DTYPE) for t in (q32, k32, v32))
    b, h, n, dh = shape
    scale = dh**-0.5
    plain, plain32 = global_attention_plain(q, k, v, scale), global_attention_plain(
        q32, k32, v32, scale)
    bound = bf16_steps(plain)
    bound_ms, bound_by = _bound(4 * b * h * n * dh * q.element_size(), 4 * b * h * n * n * dh)
    base = dict(phase="probe_attn", shape=list(shape), dtype="bfloat16", bound_ms=bound_ms,
                bound_by=bound_by, card=card)
    built = _tile_build_info() if timed else {}
    recs = []

    def record(name, fn, f32=None, **extra):
        """Time fn and hold it against the plain version; f32: the same
        function on the f32 draws, held against the f32 plain version."""
        out = fn()
        rec = dict(base, name=name, ms=cuda_ms(fn, iters) if timed else None,
                   max_abs_err=float((out.float() - plain.float()).abs().max()), **extra)
        if f32 is not None:
            rec.update(bound=bound, max_abs_err_f32=float((f32() - plain32).abs().max()),
                       bound_f32=F32_BOUND)
        recs.append(rec)
        return out

    record("einsum_f32", lambda: global_attention_plain(q, k, v, scale))
    record("einsum_bf16", lambda: einsum_bf16_softmax(q, k, v, scale))
    k5 = record("attn_fwd", lambda: global_attention(q, k, v, scale),
                lambda: global_attention(q32, k32, v32, scale))
    record("sdpa", lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    for bq, bk in (*TILES, (JAX_BLOCK, JAX_BLOCK)):
        tile = dict(tile=[bq, bk], smem_bytes=attn_tile_smem(bq, bk, dh, DTYPE),
                    fits=attn_tile_fits(bq, bk, dh, DTYPE),
                    **built.get((dh, bq, bk, "bfloat16"), {}))
        if (bq, bk) not in TILES or not tile["fits"]:  # recorded, never launched
            recs.append(dict(base, name=f"tile_{bq}x{bk}", ms=None, max_abs_err=None, **tile))
            continue
        out = record(f"tile_{bq}x{bk}", lambda: attn_fwd_tiles(q, k, v, scale, bq, bk),
                     lambda: attn_fwd_tiles(q32, k32, v32, scale, bq, bk), **tile)
        if (bq, bk) == (64, 64):
            recs[-1]["equals_attn_fwd"] = bool(torch.equal(out, k5))
    times = {r["name"]: r["ms"] for r in recs}
    for rec in recs:
        if rec["name"].startswith("tile_") or rec["name"] == "attn_fwd":
            rec.update(plain_ms=times["einsum_f32"], library_ms=times["sdpa"])
    del q, k, v, q32, k32, v32, plain, plain32, k5
    recs += _patchify(rng, dev, image, iters, timed, card)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def _patchify(rng, dev, image: int, iters: int, timed: bool, card: str):
    """The stride-16 patchify as F.conv2d and as the port's PatchEmbed
    (reshape + matmul) on one seeded image and weight, in bf16: times and
    parity."""
    img = torch.from_numpy(rng.randn(1, image, image, 3).astype(np.float32)).to(dev, DTYPE)
    embed = PatchEmbed(3, EMBED, PATCH).to(dev)
    with torch.no_grad():
        embed.proj.weight.copy_(torch.from_numpy(
            (rng.randn(EMBED, 3, PATCH, PATCH) * 0.02).astype(np.float32)))
        embed.proj.bias.copy_(torch.from_numpy((rng.randn(EMBED) * 0.02).astype(np.float32)))
        weight, bias = embed.proj.weight.to(DTYPE), embed.proj.bias.to(DTYPE)

        def conv():
            return F.conv2d(img.permute(0, 3, 1, 2), weight, bias, stride=PATCH).permute(0, 2, 3, 1)

        def matmul():
            return embed(img)

        parity = float((conv().float() - matmul().float()).abs().max())
        side = image // PATCH
        nbytes = (img.numel() + weight.numel() + EMBED + side * side * EMBED) * img.element_size()
        bound_ms, bound_by = _bound(nbytes, 2 * side * side * 3 * PATCH * PATCH * EMBED)
        base = dict(phase="probe_patchify", image=[1, 3, image, image],
                    out=[1, side, side, EMBED], dtype="bfloat16", parity_max_abs_diff=parity,
                    bound_ms=bound_ms, bound_by=bound_by, card=card)
        return [dict(base, name=name, ms=cuda_ms(fn, iters) if timed else None)
                for name, fn in (("conv", conv), ("matmul", matmul))]


def failures(recs):
    """The checks a probe run failed: K5 or a tile beyond its bound in bf16
    or in f32, or the (64, 64) tile not K5's output."""
    held = [r for r in recs if "bound" in r]
    bad = [f"{r['name']}: max |kernel - plain| {r['max_abs_err']} > {r['bound']}"
           for r in held if not r["max_abs_err"] <= r["bound"]]
    bad += [f"{r['name']}: f32 max |kernel - plain| {r['max_abs_err_f32']} > {r['bound_f32']}"
            for r in held if not r["max_abs_err_f32"] <= r["bound_f32"]]
    return bad + [f"{r['name']} differs from K5" for r in recs if r.get("equals_attn_fwd") is False]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20, help="timed calls per measurement")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("backbone_fix_probe times the CUDA kernels: it needs an NVIDIA card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bad = failures(probe("cuda", card, iters=args.iters))
    if bad:
        raise SystemExit("; ".join(bad))


if __name__ == "__main__":
    main()
