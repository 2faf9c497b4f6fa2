"""ResNet-C4 backbone and Res5 box head with frozen BatchNorm.

Port of unit_tpu/models/resnet.py.  Public functions keep the JAX layout
(images and feature maps [B, H, W, C]); inside, convolutions run on NCHW
tensors in ``torch.channels_last`` memory format, so ``x.permute(0, 2, 3, 1)``
of an output is already a contiguous [B, H, W, C] tensor (what the ROIAlign
kernel reads) and the way back into Res5 is free as well.

Parameters are float32; ``dtype`` is the compute dtype (``TPU.COMPUTE_DTYPE``),
to which inputs and weights are cast at each convolution, as flax does with
``nn.Conv(dtype=...)``.  Module and attribute names follow the flax parameter
tree, so ``checkpoint.jax_params.load_jax_params`` maps paths one to one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# d2 ResNet stage specs: number of bottleneck blocks per stage for each depth.
BLOCKS_PER_STAGE = {
    26: (1, 1, 1, 1),  # tiny bottleneck variant for fast tests (not in d2)
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """flax ``lecun_normal``: truncated normal (+-2 sigma) of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return t


class Conv2d(nn.Module):
    """Square-kernel convolution with fp32 weight [O, I, k, k] run in ``dtype``.

    ``init_std=None`` draws flax's default ``lecun_normal``; a float draws
    ``normal(init_std)`` (the RPN head).  Biases start at zero.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32,
                 init_std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        if init_std is None:
            lecun_normal_(self.weight, in_ch * kernel * kernel, generator)
        else:
            with torch.no_grad():
                self.weight.normal_(0.0, init_std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, self.padding, self.dilation)


class FrozenBN(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias with constant buffers.

    Scale and shift are formed in f32 and cast to the compute dtype before
    they touch ``x`` (unit_tpu resnet.py:56-58).  Starts as the identity.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.var + self.eps)
        shift = self.bias - self.mean * scale
        shape = (1, -1, 1, 1)
        return x * scale.to(self.dtype).view(shape) + shift.to(self.dtype).view(shape)


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, bottleneck: int, stride: int = 1,
                 stride_in_1x1: bool = True, dilation: int = 1,
                 use_shortcut: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s1 = stride if stride_in_1x1 else 1
        s3 = 1 if stride_in_1x1 else stride
        d = dilation
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = Conv2d(in_ch, bottleneck, 1, stride=s1, **kw)
        self.conv1_bn = FrozenBN(bottleneck, dtype=dtype)
        self.conv2 = Conv2d(bottleneck, bottleneck, 3, stride=s3, padding=d, dilation=d, **kw)
        self.conv2_bn = FrozenBN(bottleneck, dtype=dtype)
        self.conv3 = Conv2d(bottleneck, out_ch, 1, **kw)
        self.conv3_bn = FrozenBN(out_ch, dtype=dtype)
        if use_shortcut:
            self.shortcut = Conv2d(in_ch, out_ch, 1, stride=stride, **kw)
            self.shortcut_bn = FrozenBN(out_ch, dtype=dtype)
        else:
            self.shortcut = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1_bn(self.conv1(x)))
        out = F.relu(self.conv2_bn(self.conv2(out)))
        out = self.conv3_bn(self.conv3(out))
        sc = x if self.shortcut is None else self.shortcut_bn(self.shortcut(x))
        return F.relu(out + sc)


class ResNetStage(nn.Module):
    def __init__(self, num_blocks: int, in_ch: int, out_ch: int, bottleneck: int,
                 first_stride: int = 1, stride_in_1x1: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", BottleneckBlock(
                in_ch if i == 0 else out_ch, out_ch, bottleneck,
                stride=first_stride if i == 0 else 1, stride_in_1x1=stride_in_1x1,
                use_shortcut=(i == 0), dtype=dtype, generator=generator,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResNetC4(nn.Module):
    """Stem + res2..res4: [B, H, W, 3] -> NCHW channels_last, stride 16,
    ``res2_out_channels * 4`` channels (1024 for the published widths)."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = True,
                 stem_channels: int = 64, res2_out_channels: int = 256,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        blocks = BLOCKS_PER_STAGE[depth]
        self.dtype = dtype
        self.stem_conv1 = Conv2d(3, stem_channels, 7, stride=2, padding=3,
                                 dtype=dtype, generator=generator)
        self.stem_conv1_bn = FrozenBN(stem_channels, dtype=dtype)
        in_ch, out_ch = stem_channels, res2_out_channels
        for stage_idx in range(3):  # res2, res3, res4
            self.add_module(f"res{stage_idx + 2}", ResNetStage(
                blocks[stage_idx], in_ch, out_ch, out_ch // 4,
                first_stride=1 if stage_idx == 0 else 2,
                stride_in_1x1=stride_in_1x1, dtype=dtype, generator=generator,
            ))
            in_ch, out_ch = out_ch, out_ch * 2
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] -> [B, C, H/16, W/16] (channels_last memory)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_conv1_bn(self.stem_conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        return self.res4(self.res3(self.res2(x)))


class Res5(nn.Module):
    """res5 over pooled ROI maps [N, P, P, C] -> spatial mean [N, 8 * res2]."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = True,
                 res2_out_channels: int = 256, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = res2_out_channels * 8
        self.dtype = dtype
        self.res5 = ResNetStage(
            BLOCKS_PER_STAGE[depth][3], out_ch // 2, out_ch, out_ch // 4,
            first_stride=2, stride_in_1x1=stride_in_1x1, dtype=dtype,
            generator=generator,
        )
        self.out_channels = out_ch

    def forward(self, x: torch.Tensor, spatial_mean: bool = True) -> torch.Tensor:
        x = self.res5(x.permute(0, 3, 1, 2).to(self.dtype))
        return x.mean(dim=(2, 3)) if spatial_mean else x.permute(0, 2, 3, 1)
