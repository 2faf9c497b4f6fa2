"""Backbones by registry name: ResNet-C4 and InceptionResNetV2.

Port of unit_tpu/models/backbones.py:106-213 (the note suite's backbone; VGG16
and VGG-CNN-F, the dock suite's, are ROADMAP Queue 1 item 25a).
``InceptionResNetV2`` is cut after the block17 stage: 1088 channels at stride
16, but its stem's unpadded ("VALID") convolutions and pools make the map
smaller than ceil(H/16) x ceil(W/16) (35x48 for a 600x800 canvas, where
ResNet-C4 gives 38x50).  The anchors and the pooler follow the map they get.

Layout and precision as in models/resnet.py: [B, H, W, 3] in, NCHW in
``torch.channels_last`` memory out; f32 parameters, every convolution in
``dtype``.  Module names follow the flax tree (``conv2d_1a``, ``block35_0/b1_1``
...), so ``checkpoint.jax_params`` maps them one to one.  flax ``"SAME"`` at
stride 1 pads (k - 1) / 2 on each side of each axis (a 1x7 kernel (0, 3));
the stride-2 convolutions and every max pool are unpadded.  Inits follow
flax: lecun_normal kernels, zero biases.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d, ResNetC4


def _conv(in_ch: int, out_ch: int, kernel, stride: int = 1, valid: bool = False,
          **kw) -> Conv2d:
    """flax ``nn.Conv`` with a bias: "SAME" (at stride 1, (k - 1) / 2 on each
    side of each axis) unless ``valid``."""
    k = (kernel, kernel) if isinstance(kernel, int) else kernel
    pad = 0 if valid else (k[0] // 2, k[1] // 2)
    return Conv2d(in_ch, out_ch, k, stride=stride, padding=pad, bias=True, **kw)


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


def build_inception_resnet_v2_backbone(dtype: torch.dtype = torch.float32,
                                       generator: Optional[torch.Generator] = None,
                                       **_) -> InceptionResNetV2:
    return InceptionResNetV2(dtype=dtype, generator=generator)


# MODEL.BACKBONE.NAME -> constructor, with the reference's aliases (its
# backbone.py:103); VGG and VGG_CNN_F are not ported
BACKBONE_REGISTRY = {
    "build_resnet_backbone": ResNetC4,
    "build_inception_resnet_v2_backbone": build_inception_resnet_v2_backbone,
    "InceptionResNetV2": build_inception_resnet_v2_backbone,
}


def build_backbone(name: str, depth: int = 50, res2_out_channels: int = 256,
                   dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """The backbone MODEL.BACKBONE.NAME names; it has ``out_channels``."""
    return BACKBONE_REGISTRY[name](depth=depth, res2_out_channels=res2_out_channels,
                                   dtype=dtype, generator=generator)
