"""Backbones by registry name: ResNet-C4, VGG16, VGG-CNN-F and InceptionResNetV2.

Port of unit_tpu/models/backbones.py.  ``InceptionResNetV2`` (the note
suite's) is cut after the block17 stage: 1088 channels at stride 16, but its
stem's unpadded ("VALID") convolutions and pools make the map smaller than
ceil(H/16) x ceil(W/16) (35x48 for a 600x800 canvas, where ResNet-C4 gives
38x50).  ``VGGCNNF`` (the dock suite's Caffe VGG-CNN-F, 256 channels) opens
with an unpadded 11x11 convolution at stride 4, and each of its two 3x3 max
pools pads one row and one column of -inf at the bottom and right only: an
800x1344 canvas gives a 49x83 map.  ``VGG16`` (512 channels) has four 2x2
pools; ``dilated`` widens conv5's taps to dilation 2 (and its "SAME" pad to
2) and keeps every pool, as unit_tpu's code does.  The anchors and the pooler
follow the map they get.

Layout and precision as in models/resnet.py: [B, H, W, 3] in, NCHW in
``torch.channels_last`` memory out; f32 parameters, every convolution in
``dtype``.  Module names follow the flax tree (``conv2d_1a``, ``block35_0/b1_1``
...), so ``checkpoint.jax_params`` maps them one to one.  flax ``"SAME"`` at
stride 1 pads (k - 1) / 2 on each side of each axis (a 1x7 kernel (0, 3));
the stride-2 convolutions and every max pool are unpadded (but VGG-CNN-F's,
above).  Inits follow flax: lecun_normal kernels, zero biases.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import Registry
from .resnet import Conv2d, ResNetC4

# MODEL.BACKBONE.NAME -> constructor, with the reference's aliases (its
# backbone.py:58, 82, 103)
BACKBONE_REGISTRY = Registry("BACKBONE")


def _conv(in_ch: int, out_ch: int, kernel, stride: int = 1, valid: bool = False,
          **kw) -> Conv2d:
    """flax ``nn.Conv`` with a bias: "SAME" (at stride 1, (k - 1) / 2 on each
    side of each axis) unless ``valid``."""
    k = (kernel, kernel) if isinstance(kernel, int) else kernel
    pad = 0 if valid else (k[0] // 2, k[1] // 2)
    return Conv2d(in_ch, out_ch, k, stride=stride, padding=pad, bias=True, **kw)


class LocalResponseNorm(nn.Module):
    """Caffe's cross-channel LRN (VGG-CNN-F): x / (k + alpha * S)^beta, S the
    sum of x^2 over ``size`` neighbouring channels (zeros past the ends).
    Not ``F.local_response_norm``, which divides alpha by the size and
    defaults k to 1.  The window is summed channel by channel in the compute
    dtype, in unit_tpu's order."""

    def __init__(self, size: int = 5, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 2.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        half, c = self.size // 2, x.shape[1]
        padded = F.pad(x * x, (0, 0, 0, 0, half, half))
        acc = torch.zeros_like(x)
        for i in range(self.size):
            acc = acc + padded[:, i:i + c]
        return x / (self.k + self.alpha * acc) ** self.beta


def _max_pool_bottom_right(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool(x, (3, 3), (2, 2), padding=((0, 1), (0, 1)))``: one row
    and one column of -inf at the bottom and right, then the pool
    (``max_pool2d``'s own padding would pad both sides)."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)


class VGGCNNF(nn.Module):
    """Caffe VGG-CNN-F: conv1 11x11/4 unpadded + LRN + pool, conv2 5x5 + LRN +
    pool, conv3-5 3x3; [B, H, W, 3] -> [B, 256, h, w], stride 16."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 11, stride=4, valid=True, **kw)
        self.norm1 = LocalResponseNorm()
        self.conv2 = _conv(64, 256, 5, **kw)
        self.norm2 = LocalResponseNorm()
        self.conv3 = _conv(256, 256, 3, **kw)
        self.conv4 = _conv(256, 256, 3, **kw)
        self.conv5 = _conv(256, 256, 3, **kw)
        self.out_channels = 256

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = _max_pool_bottom_right(self.norm1(F.relu(self.conv1(x))))
        x = _max_pool_bottom_right(self.norm2(F.relu(self.conv2(x))))
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        return F.relu(self.conv5(x)).contiguous(memory_format=torch.channels_last)


class VGG16(nn.Module):
    """torchvision VGG16's features through conv5_3, named conv0 ... conv12
    as in the flax tree: 3x3 "SAME" convolutions with a 2x2 max pool after
    each of the first four blocks; [B, H, W, 3] -> [B, 512, h, w], stride 16.
    ``dilated``: conv5's three convolutions at dilation 2."""

    _BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512))

    def __init__(self, dilated: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.dtype = dtype
        in_ch, idx = 3, 0
        for n, ch in self._BLOCKS:
            for _ in range(n):
                self.add_module(f"conv{idx}", _conv(in_ch, ch, 3, **kw))
                in_ch, idx = ch, idx + 1
        d = 2 if dilated else 1
        for _ in range(3):
            self.add_module(f"conv{idx}", Conv2d(512, 512, 3, padding=d, dilation=d,
                                                 bias=True, **kw))
            idx += 1
        self.out_channels = 512

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        idx = 0
        for n, _ in self._BLOCKS:
            for _ in range(n):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            x = F.max_pool2d(x, 2, 2)
        for i in range(idx, idx + 3):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


class _IRBlock35(nn.Module):
    """Inception-ResNet-A on 320 channels: relu(x + 0.17 * up(branches))."""

    def __init__(self, channels: int = 320, scale: float = 0.17,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.scale = scale
        self.b0 = _conv(channels, 32, 1, **kw)
        self.b1_0 = _conv(channels, 32, 1, **kw)
        self.b1_1 = _conv(32, 32, 3, **kw)
        self.b2_0 = _conv(channels, 32, 1, **kw)
        self.b2_1 = _conv(32, 48, 3, **kw)
        self.b2_2 = _conv(48, 64, 3, **kw)
        self.up = _conv(128, channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = F.relu(self.b0(x))
        b1 = F.relu(self.b1_1(F.relu(self.b1_0(x))))
        b2 = F.relu(self.b2_2(F.relu(self.b2_1(F.relu(self.b2_0(x))))))
        up = self.up(torch.cat([b0, b1, b2], 1))
        # in the compute dtype, rounded after the product and after the sum
        # as unit_tpu's ``x + self.scale * up`` is
        return F.relu(x + self.scale * up)


class _IRBlock17(nn.Module):
    """Inception-ResNet-B on 1088 channels (1x7 then 7x1 branch):
    relu(x + 0.1 * up(branches))."""

    def __init__(self, channels: int = 1088, scale: float = 0.10,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.scale = scale
        self.b0 = _conv(channels, 192, 1, **kw)
        self.b1_0 = _conv(channels, 128, 1, **kw)
        self.b1_1 = _conv(128, 160, (1, 7), **kw)
        self.b1_2 = _conv(160, 192, (7, 1), **kw)
        self.up = _conv(384, channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = F.relu(self.b0(x))
        b1 = F.relu(self.b1_2(F.relu(self.b1_1(F.relu(self.b1_0(x))))))
        up = self.up(torch.cat([b0, b1], 1))
        return F.relu(x + self.scale * up)


class InceptionResNetV2(nn.Module):
    """InceptionResNetV2 through the block17 stage: stem, mixed_5b,
    ``num_block35`` x block35, mixed_6a, ``num_block17`` x block17;
    [B, H, W, 3] -> [B, 1088, h, w] (channels_last memory), stride 16."""

    def __init__(self, num_block35: int = 10, num_block17: int = 20,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.dtype = dtype
        self.num_block35, self.num_block17 = num_block35, num_block17
        self.conv2d_1a = _conv(3, 32, 3, stride=2, valid=True, **kw)
        self.conv2d_2a = _conv(32, 32, 3, valid=True, **kw)
        self.conv2d_2b = _conv(32, 64, 3, **kw)
        self.conv2d_3b = _conv(64, 80, 1, valid=True, **kw)
        self.conv2d_4a = _conv(80, 192, 3, valid=True, **kw)
        self.m5b_b0 = _conv(192, 96, 1, **kw)
        self.m5b_b1_0 = _conv(192, 48, 1, **kw)
        self.m5b_b1_1 = _conv(48, 64, 5, **kw)
        self.m5b_b2_0 = _conv(192, 64, 1, **kw)
        self.m5b_b2_1 = _conv(64, 96, 3, **kw)
        self.m5b_b2_2 = _conv(96, 96, 3, **kw)
        self.m5b_b3 = _conv(192, 64, 1, **kw)
        for i in range(num_block35):
            self.add_module(f"block35_{i}", _IRBlock35(320, **kw))
        self.m6a_b0 = _conv(320, 384, 3, stride=2, valid=True, **kw)
        self.m6a_b1_0 = _conv(320, 256, 1, **kw)
        self.m6a_b1_1 = _conv(256, 256, 3, **kw)
        self.m6a_b1_2 = _conv(256, 384, 3, stride=2, valid=True, **kw)
        self.out_channels = 384 + 384 + 320
        for i in range(num_block17):
            self.add_module(f"block17_{i}", _IRBlock17(self.out_channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.conv2d_1a(x))
        x = F.relu(self.conv2d_2a(x))
        x = F.relu(self.conv2d_2b(x))
        x = F.max_pool2d(x, 3, 2)
        x = F.relu(self.conv2d_3b(x))
        x = F.relu(self.conv2d_4a(x))
        x = F.max_pool2d(x, 3, 2)
        b0 = F.relu(self.m5b_b0(x))
        b1 = F.relu(self.m5b_b1_1(F.relu(self.m5b_b1_0(x))))
        b2 = F.relu(self.m5b_b2_2(F.relu(self.m5b_b2_1(F.relu(self.m5b_b2_0(x))))))
        # flax avg_pool "SAME" counts the padded zeros in every window
        b3 = F.relu(self.m5b_b3(F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)))
        x = torch.cat([b0, b1, b2, b3], 1)
        for i in range(self.num_block35):
            x = getattr(self, f"block35_{i}")(x)
        b0 = F.relu(self.m6a_b0(x))
        b1 = F.relu(self.m6a_b1_2(F.relu(self.m6a_b1_1(F.relu(self.m6a_b1_0(x))))))
        x = torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], 1)
        for i in range(self.num_block17):
            x = getattr(self, f"block17_{i}")(x)
        return x


@BACKBONE_REGISTRY.register()
def build_inception_resnet_v2_backbone(dtype: torch.dtype = torch.float32,
                                       generator: Optional[torch.Generator] = None,
                                       **_) -> InceptionResNetV2:
    return InceptionResNetV2(dtype=dtype, generator=generator)


@BACKBONE_REGISTRY.register()
def build_vgg_backbone(dilated: bool = False, dtype: torch.dtype = torch.float32,
                       generator: Optional[torch.Generator] = None, **_) -> VGG16:
    return VGG16(dilated=dilated, dtype=dtype, generator=generator)


@BACKBONE_REGISTRY.register()
def build_vgg_cnn_f_backbone(dtype: torch.dtype = torch.float32,
                             generator: Optional[torch.Generator] = None, **_) -> VGGCNNF:
    return VGGCNNF(dtype=dtype, generator=generator)


@BACKBONE_REGISTRY.register(name="build_resnet_backbone")
def _resnet(depth: int = 50, res2_out_channels: int = 256, dtype: torch.dtype = torch.float32,
            generator: Optional[torch.Generator] = None, **_) -> ResNetC4:
    return ResNetC4(depth=depth, res2_out_channels=res2_out_channels, dtype=dtype,
                    generator=generator)


BACKBONE_REGISTRY.register(build_vgg_backbone, name="VGG")
BACKBONE_REGISTRY.register(build_vgg_cnn_f_backbone, name="VGG_CNN_F")
BACKBONE_REGISTRY.register(build_inception_resnet_v2_backbone, name="InceptionResNetV2")


def build_backbone(name: str, depth: int = 50, res2_out_channels: int = 256,
                   dilated: bool = False, dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """The backbone MODEL.BACKBONE.NAME names (``dilated``: VGG16's
    MODEL.BACKBONE.DILATED); it has ``out_channels``."""
    return BACKBONE_REGISTRY.get(name)(depth=depth, res2_out_channels=res2_out_channels,
                                       dilated=dilated, dtype=dtype, generator=generator)
