"""ResNet backbone of the APE-DETA R50 family (counterpart of
``ape_tpu/modeling/backbone/resnet.py``): detectron2's ``BasicStem`` and
bottleneck stages with ``stride_in_1x1=False`` and FrozenBN everywhere,
``freeze_at=1``.

The convolutions are cuDNN's through ``F.conv2d`` (JAX's are XLA's; no
Pallas kernel runs here). The port passes channels-last (B, H, W, C) maps
between modules; the ResNet runs its convolutions on the NCHW view of that
layout (``torch.channels_last`` memory), so neither its input nor its
outputs are copied to change layout.

FrozenBN mirrors JAX's arithmetic: ``mul = scale * rsqrt(var + eps)`` and
``add = bias - mean * scale * rsqrt(var + eps)`` in f32, both rounded to the
compute dtype, then ``x * mul + add`` in that dtype: in bf16 the product
rounds, then the sum, as XLA computes it (one FMA rounded once would put
elements where the two terms cancel several bf16 steps from JAX's). It is
not folded into the convolution's weights. Its four constants are
buffers under detectron2's names (``weight``, ``bias``, ``running_mean``,
``running_var``): they never train. The gradient stops at the stem's
output (``freeze_at=1``, as JAX's ``stop_gradient``): the stem's
convolution stays a parameter whose gradient is zero, and the optimizer
still decays it as optax does (``engine/optimizer.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# ResNet-50's bottleneck blocks per stage (res2 .. res5)
STAGE_BLOCKS = (3, 4, 6, 3)


class FrozenBatchNorm(nn.Module):
    """Batch norm with frozen statistics and affine (d2 FrozenBatchNorm2d),
    over dim 1 of an NCHW map."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = (self.weight * inv).to(x.dtype)
        add = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]


class Conv2d(nn.Conv2d):
    """Bias-free conv with a FrozenBN ``norm`` after it, in the input's
    dtype (d2 ``Conv2d(norm="FrozenBN")``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=kernel // 2, bias=False)
        self.norm = FrozenBatchNorm(out_channels)

    def forward(self, x):
        return self.norm(F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding))


class BasicStem(nn.Module):
    """7x7/2 conv, FrozenBN, ReLU, 3x3/2 max pool with padding 1."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 7, 2)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1, each with FrozenBN; a projection
    shortcut on a stage's first block."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, shortcut: bool = False):
        super().__init__()
        self.shortcut = Conv2d(in_channels, out_channels, 1, stride) if shortcut else None
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1)
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3, stride)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1)

    def forward(self, x):
        sc = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + sc)


class ResNet(nn.Module):
    """detectron2's ResNet-50 with ``freeze_at=1``: {res2 .. res5} as (B, H,
    W, C) maps of 256, 512, 1024 and 2048 channels (``out_channels``), at
    strides 4 to 32; the gradient stops at the stem's output."""

    def __init__(self):
        super().__init__()
        self.stem = BasicStem(3, 64)
        self.stage_names = []
        self.out_channels: Dict[str, int] = {}
        in_ch, out_ch = 64, 256
        for i, blocks in enumerate(STAGE_BLOCKS):
            name = f"res{i + 2}"
            stage = nn.Sequential(*(
                BottleneckBlock(in_ch if j == 0 else out_ch, out_ch, out_ch // 4,
                                (1 if i == 0 else 2) if j == 0 else 1, shortcut=j == 0)
                for j in range(blocks)))
            self.add_module(name, stage)
            self.stage_names.append(name)
            self.out_channels[name] = out_ch
            in_ch, out_ch = out_ch, out_ch * 2

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                rows=None) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3) -> {name: (B, H_s, W_s, C_s)}. ``generator`` and
        ``rows`` are unused (the ResNet draws nothing; the ViT backbones'
        signature)."""
        del generator, rows
        x = self.stem(x.permute(0, 3, 1, 2)).detach()
        feats = {}
        for name in self.stage_names:
            x = getattr(self, name)(x)
            feats[name] = x.permute(0, 2, 3, 1)
        return feats
