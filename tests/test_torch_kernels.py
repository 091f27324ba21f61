"""The port's CUDA kernels against their plain versions on an NVIDIA card.

These tests (forward and backward kernels) need a CUDA device and the CUDA toolkit: the kernels have no CPU
mode, so without a card they skip. The file imports neither JAX nor the
test conftest, so it runs on a machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from ape_tpu_torch.ops import _build
from ape_tpu_torch.ops.attention import (
    attn_bwd_cuda,
    attn_fwd_cuda,
    global_attention,
    global_attention_plain,
)
from ape_tpu_torch.ops.msda import ms_deform_attn
from ape_tpu_torch.ops.msda_dispatch import msda_bwd_cuda, msda_fwd_cuda, ms_deform_attn_window

pytestmark = pytest.mark.cuda

# bf16 rounds the value and the output once each; f32 differs only by order
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_kernel_matches_plain(device, dtype):
    rng = np.random.RandomState(0)
    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(2, s, 8, 32).astype(np.float32)).to(device, dtype)
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, 37, 8, 3, 4, 2)).astype(np.float32)).to(device)
    att = torch.from_numpy(rng.rand(2, 37, 8, 3, 4).astype(np.float32)).to(device, dtype)
    got = msda_fwd_cuda(value, shapes, loc, att).float()
    want = ms_deform_attn(value.float(), shapes, loc, att.float())
    assert got.shape == (2, 37, 256)
    assert float((got - want).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dh", [(333, 64), (64, 32), (200, 128)])
def test_attention_kernel_matches_plain(device, dtype, n, dh):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, n, dh).astype(np.float32)).to(device, dtype)
               for _ in range(3))
    got = attn_fwd_cuda(q, k, v, dh**-0.5).float()
    want = global_attention_plain(q.float(), k.float(), v.float(), dh**-0.5)
    assert float((got - want).abs().max()) < TOL[dtype]


def _msda_grad_inputs(device, dtype, b=2, q=37, seed=2):
    rng = np.random.RandomState(seed)
    shapes = ((16, 16), (8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(b, s, 8, 32).astype(np.float32)).to(device, dtype)
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (b, q, 8, 3, 4, 2)).astype(np.float32)).to(device)
    att = torch.from_numpy(rng.rand(b, q, 8, 3, 4).astype(np.float32)).to(device, dtype)
    grad = torch.from_numpy(rng.randn(b, q, 256).astype(np.float32)).to(device, dtype)
    return shapes, value, loc, att, grad


# f32: the kernel sums d_value with atomics in a run-dependent order, and
# d_loc carries a factor of the level size, so 1e-4 absolute on values of
# order 10. bf16: value and grad are rounded to 8 bits before both versions.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_backward_kernel_matches_autograd(device, dtype):
    shapes, value, loc, att, grad = _msda_grad_inputs(device, dtype)
    got = msda_bwd_cuda(value, shapes, loc, att, grad)
    leaves = [value.detach().float().requires_grad_(), loc.clone().requires_grad_(),
              att.detach().float().requires_grad_()]
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    want = torch.autograd.grad(out, leaves, grad.float())
    for name, g, w in zip(("value", "loc", "att"), got, want):
        assert g.shape == w.shape, name
        scale = max(1.0, float(w.abs().max()))
        assert float((g.float() - w).abs().max()) < GRAD_TOL[dtype] * scale, name


def test_msda_autograd_runs_the_kernels(device):
    shapes, value, loc, att, grad = _msda_grad_inputs(device, torch.float32, q=sum(
        h * w for h, w in ((16, 16), (8, 8), (4, 4))))
    _build.reset_launches()
    off = torch.zeros(2, value.shape[1], 8, 3, 4, 2, device=device, requires_grad=True)
    v = value.clone().requires_grad_()
    out = ms_deform_attn_window(v, shapes, off, att, 2)
    out.backward(grad)
    assert _build.LAUNCHES["msda_fwd"] == 1 and _build.LAUNCHES["msda_bwd"] == 1
    assert torch.isfinite(off.grad).all() and torch.isfinite(v.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dh", [(333, 64), (64, 32), (200, 128)])
def test_attention_backward_kernels_match_autograd(device, dtype, n, dh):
    rng = np.random.RandomState(3)
    q, k, v, go = (torch.from_numpy(rng.randn(2, 3, n, dh).astype(np.float32)).to(device, dtype)
                   for _ in range(4))
    out, lse = attn_fwd_cuda(q, k, v, dh**-0.5, with_lse=True)
    got = attn_bwd_cuda(q, k, v, out, go, lse, dh**-0.5)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(global_attention_plain(*leaves, dh**-0.5), leaves, go.float())
    ref_lse = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) * dh**-0.5, -1)
    assert float((lse - ref_lse).abs().max()) < 1e-4
    for name, g, w in zip("qkv", got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g.float() - w).abs().max()) < GRAD_TOL[dtype] * scale, name
    _build.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    global_attention(*leaves, dh**-0.5).backward(go)
    assert {k: _build.LAUNCHES[k] for k in ("attn_fwd", "attn_bwd_delta", "attn_bwd_dkv",
                                            "attn_bwd_dq")} == dict.fromkeys(
        ("attn_fwd", "attn_bwd_delta", "attn_bwd_dkv", "attn_bwd_dq"), 1)
