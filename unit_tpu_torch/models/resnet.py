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
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_act import bn_act

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
    """Convolution with fp32 weight [O, I, kh, kw] run in ``dtype``.

    ``kernel`` and ``padding`` are an int (square) or an (h, w) pair.
    ``init_std=None`` draws flax's default ``lecun_normal``; a float draws
    ``normal(init_std)`` (the RPN head).  Biases start at zero.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1,
                 padding=0, dilation: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32,
                 init_std: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        if init_std is None:
            lecun_normal_(self.weight, in_ch * kh * kw, generator)
        else:
            with torch.no_grad():
                self.weight.normal_(0.0, init_std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, self.padding, self.dilation)


class FrozenBN(nn.Module):
    """y = act((x - mean) / sqrt(var + eps) * weight + bias [+ residual]) with
    constant buffers, as one fused epilogue (``ops.bn_act``).

    Scale and shift are formed in f32 from the four buffers on every call (the
    buffers may be reloaded or folded between calls) and the epilogue computes
    in f32 and rounds once to the dtype of ``x``.  unit_tpu's FrozenBN
    (resnet.py:56-58) rounds scale, shift and each intermediate to the compute
    dtype instead: the same values in f32, about one bf16 ulp per epilogue
    apart in bf16.  ``impl`` (auto | cuda | plain) picks the hand-written
    kernel or the plain version; ``set_bn_act_impl`` sets it for a whole model.
    Starts as the identity.

    PreciseBN (utils/precise_bn.py) sets ``batch_stats`` to a list: each call
    then appends the per-channel mean and population variance of its input
    ``x`` (``input_stats``), taken before the current buffers apply.  None,
    the default, captures nothing.
    """

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.impl = "auto"
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.batch_stats: Optional[list] = None

    def scale_shift(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The affine form of the four buffers, f32 [C] each."""
        scale = self.weight / torch.sqrt(self.var + self.eps)
        return scale, self.bias - self.mean * scale

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        if self.batch_stats is not None:
            self.batch_stats.append(input_stats(x))
        scale, shift = self.scale_shift()
        return bn_act(x, scale, shift, residual, relu, self.impl)


def input_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, population variance) of an NCHW map over N, H and W,
    computed in f32 and rounded to the dtype of ``x``, as unit_tpu's
    ``jnp.mean``/``jnp.var`` are (bf16 in, bf16 out).  A channels_last map is
    reduced as it lies: no layout copy, one f32 copy for a bf16 map."""
    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
    return mean.to(x.dtype), var.to(x.dtype)


def set_bn_act_impl(module: nn.Module, impl: str) -> None:
    """Route every FrozenBN under ``module`` to ``impl`` (auto | cuda | plain)."""
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown bn_act impl {impl!r} (auto | cuda | plain)")
    for m in module.modules():
        if isinstance(m, FrozenBN):
            m.impl = impl


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
        out = self.conv1_bn(self.conv1(x), relu=True)
        out = self.conv2_bn(self.conv2(out), relu=True)
        sc = x if self.shortcut is None else self.shortcut_bn(self.shortcut(x))
        return self.conv3_bn(self.conv3(out), residual=sc, relu=True)


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

    def forward(self, x: torch.Tensor, start_block: int = 0,
                stop_block: Optional[int] = None) -> torch.Tensor:
        """Blocks ``[start_block, stop_block)`` (default: all of them)."""
        stop = self.num_blocks if stop_block is None else stop_block
        if not 0 <= start_block < stop <= self.num_blocks:
            raise ValueError(f"blocks [{start_block}, {stop}) of {self.num_blocks}")
        for i in range(start_block, stop):
            x = getattr(self, f"block{i}")(x)
        return x


def num_units(depth: int) -> int:
    """The pipeline-splittable units of a ResNet-C4 backbone (unit_tpu
    resnet.py:152-165): unit 0 is the stem (7x7 conv and max pool), units
    1.. the bottleneck blocks of res2..res4 in order.  Every interior block
    costs about the same: the map shrinks 4x as the channels' cost grows 4x."""
    blocks = BLOCKS_PER_STAGE[depth]
    return 1 + blocks[0] + blocks[1] + blocks[2]


class ResNetC4(nn.Module):
    """Stem + res2..res4: [B, H, W, 3] -> NCHW channels_last, stride 16,
    ``res2_out_channels * 4`` channels (1024 for the published widths).

    ``forward(x, start_unit, stop_unit)`` runs the contiguous units
    ``[start_unit, stop_unit)`` (``num_units``): from unit 0 ``x`` is the
    image batch, later ``x`` is the NCHW map the range before it returned, so
    chained ranges give the whole pass (a pipeline stage runs one range).
    """

    def __init__(self, depth: int = 50, stride_in_1x1: bool = True,
                 stem_channels: int = 64, res2_out_channels: int = 256,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        blocks = BLOCKS_PER_STAGE[depth]
        self.depth = depth
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

    def forward(self, x: torch.Tensor, start_unit: int = 0,
                stop_unit: Optional[int] = None) -> torch.Tensor:
        """x [B, H, W, 3] -> [B, C, H/16, W/16] (channels_last memory)."""
        n = num_units(self.depth)
        stop = n if stop_unit is None else stop_unit
        if not 0 <= start_unit < stop <= n:
            raise ValueError(f"units [{start_unit}, {stop}) of {n}")
        if start_unit == 0:
            x = x.permute(0, 3, 1, 2).to(self.dtype)
            x = self.stem_conv1_bn(self.stem_conv1(x), relu=True)
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        unit = 1  # res2's first block
        for stage in (self.res2, self.res3, self.res4):
            lo, hi = max(start_unit - unit, 0), min(stop - unit, stage.num_blocks)
            if hi > lo:
                x = stage(x, lo, hi)
            unit += stage.num_blocks
        return x


class Res5(nn.Module):
    """res5 over pooled ROI maps [N, P, P, C] -> spatial mean [N, 8 * res2].

    ``in_channels`` is C, the pooled map's width (None: ResNet-C4's res4,
    4 * res2): flax infers it, so unit_tpu runs the same head over
    VGG-CNN-F's 256, VGG16's 512 or InceptionResNetV2's 1088 channels, and
    the first block's projection shortcut and conv1 are built over it.  The
    stride-2 1x1 conv1 (``stride_in_1x1``) takes an odd map to
    ceil(P / 2) as flax's "SAME" does: 17 -> 9, 7 -> 4."""

    def __init__(self, depth: int = 50, stride_in_1x1: bool = True,
                 res2_out_channels: int = 256, in_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = res2_out_channels * 8
        self.dtype = dtype
        self.res5 = ResNetStage(
            BLOCKS_PER_STAGE[depth][3], in_channels or out_ch // 2, out_ch, out_ch // 4,
            first_stride=2, stride_in_1x1=stride_in_1x1, dtype=dtype,
            generator=generator,
        )
        self.out_channels = out_ch

    def forward(self, x: torch.Tensor, spatial_mean: bool = True) -> torch.Tensor:
        x = self.res5(x.permute(0, 3, 1, 2).to(self.dtype))
        return x.mean(dim=(2, 3)) if spatial_mean else x.permute(0, 2, 3, 1)
