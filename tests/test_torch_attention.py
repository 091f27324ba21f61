"""The rounding of the bf16 tensor-core attention kernels, emulated on the CPU.

``csrc/attn_fwd.cuh``'s bf16 body (K5) and ``csrc/attn_bwd.cu``'s bf16
dK/dV body (K5-dkv) run on the tensor cores, which read bf16: K5 rounds the
unnormalised probabilities P to bf16 before P V, K5-dkv rounds P^T and dS^T
before dV = P^T dO and dK = dS^T Q; everything else is f32. The emulations
here repeat that arithmetic in PyTorch, tile by tile in the kernels' order
(64-key tiles, the online softmax in log2 units; 64-query tiles for dK/dV),
and are held against the plain attention and autograd of it within the
bounds ``chip_smoke.py`` and the attention probe hold the kernels to on the
card. The kernels themselves run only there (tests/test_torch_kernels.py).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from ape_tpu_torch.ops.attention import global_attention_plain
from ape_tpu_torch.tools.backbone_fix_probe import bf16_steps

TILE = 64  # keys a step of the forward, queries a step of dK/dV
LOG2E = 1.0 / math.log(2.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulated_forward(q, k, v, scale: float, round_p: bool = True):
    """K5's bf16 body on (B, H, N, Dh) bf16 tensors: (bf16 output, f32 lse)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(qf.shape)
    for k0 in range(0, k.shape[-2], TILE):
        s = (qf @ kf[..., k0:k0 + TILE, :].transpose(-1, -2)) * (scale * LOG2E)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + (_bf16(p) if round_p else p) @ vf[..., k0:k0 + TILE, :]
        m = m_new
    return (o / l[..., None]).to(q.dtype), (m + torch.log2(l)) / LOG2E


def emulated_dkv(q, k, v, d_out, lse, delta, scale: float):
    """K5-dkv's bf16 body: (dk, dv) in bf16 from the forward's lse and the
    pre-pass's delta."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, d_out))
    dk = torch.zeros(kf.shape)
    dv = torch.zeros(vf.shape)
    for q0 in range(0, q.shape[-2], TILE):
        rows = slice(q0, q0 + TILE)
        qs, gs = qf[..., rows, :], gf[..., rows, :]
        p = torch.exp2((kf @ qs.transpose(-1, -2)) * (scale * LOG2E)
                       - lse[..., None, rows] * LOG2E)  # P^T: keys x queries
        ds = p * (vf @ gs.transpose(-1, -2) - delta[..., None, rows])
        dv += _bf16(p) @ gs
        dk += _bf16(ds) @ qs
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def _draws(n: int, count: int):
    rng = np.random.RandomState(11)
    return [torch.from_numpy(rng.randn(1, 3, n, 64).astype(np.float32)).to(torch.bfloat16)
            for _ in range(count)]


@pytest.mark.parametrize("n", [1024, 1000])
def test_emulated_forward_is_the_online_softmax(n):
    """Without the bf16 rounding of P the tile loop is the exact softmax:
    the emulation's tiles, running max and ragged last tile are right."""
    q, k, v = _draws(n, 3)
    got, lse = emulated_forward(q, k, v, 0.125, round_p=False)
    want = global_attention_plain(q.float(), k.float(), v.float(), 0.125)
    assert float((got.float() - want).abs().max()) <= bf16_steps(want, 1)
    ref_lse = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) * 0.125, -1)
    assert float((lse - ref_lse).abs().max()) < 1e-4


@pytest.mark.parametrize("n", [1024, 1000])
def test_forward_rounding_within_the_card_bounds(n):
    """K5's rounding against the plain attention in bf16 (chip_smoke.py's
    bound, 3.2e-2, and the probe's four bf16 steps of the largest output)
    and in f32 on the same bf16 inputs."""
    q, k, v = _draws(n, 3)
    got, _ = emulated_forward(q, k, v, 0.125)
    plain = global_attention_plain(q, k, v, 0.125)
    plain32 = global_attention_plain(q.float(), k.float(), v.float(), 0.125)
    err = float((got.float() - plain.float()).abs().max())
    assert err <= chip_smoke.BOUNDS["bfloat16"]["attn"]
    assert err <= bf16_steps(plain)
    assert float((got.float() - plain32).abs().max()) <= bf16_steps(plain32)


@pytest.mark.parametrize("n", [1024, 1000])
def test_dkv_rounding_within_the_card_bounds(n):
    """K5-dkv's rounding, fed as on the card (the emulated forward's lse, the
    pre-pass's delta from the bf16 output), against autograd of the plain
    attention: each output within GRAD_BOUNDS of its largest entry."""
    q, k, v, go = _draws(n, 4)
    out, lse = emulated_forward(q, k, v, 0.125)
    delta = (out.float() * go.float()).sum(-1)
    dk, dv = emulated_dkv(q, k, v, go, lse, delta, 0.125)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    _, want_k, want_v = torch.autograd.grad(global_attention_plain(*leaves, 0.125), leaves,
                                            go.float())
    for got, want in ((dk, want_k), (dv, want_v)):
        rel = float((got.float() - want).abs().max()) / float(want.abs().max())
        assert rel <= chip_smoke.GRAD_BOUNDS["bfloat16"]
