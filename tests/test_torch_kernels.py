"""The port's CUDA kernels against their plain versions on an NVIDIA card.

These tests need a CUDA device and the CUDA toolkit: the kernels have no CPU
mode, so without a card they skip. The file imports neither JAX nor the
test conftest, so it runs on a machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from ape_tpu_torch.ops.attention import attn_fwd_cuda, global_attention_plain
from ape_tpu_torch.ops.msda import ms_deform_attn
from ape_tpu_torch.ops.msda_dispatch import msda_fwd_cuda

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


def test_kernels_refuse_gradients(device):
    q = torch.zeros(1, 1, 64, 64, device=device, requires_grad=True)
    with pytest.raises(NotImplementedError):
        attn_fwd_cuda(q, q.detach(), q.detach(), 1.0)
    value = torch.zeros(1, 4, 1, 32, device=device, requires_grad=True)
    loc = torch.zeros(1, 3, 1, 1, 1, 2, device=device)
    with pytest.raises(NotImplementedError):
        msda_fwd_cuda(value, ((2, 2),), loc, torch.ones(1, 3, 1, 1, 1, device=device))
