"""Box heads by registry name: Res5, the VGG fc heads and the InceptionResNetV2 tail.

Port of unit_tpu/models/box_heads.py.  A head maps pooled ROIs [N, P, P, C]
to one feature vector a ROI and has ``out_channels``, from which the
predictors size themselves.

``VGGConvFCHead`` and ``VGGCNNFBoxHead`` (the dock suite's; one module under
two names, as in unit_tpu) flatten each ROI in (h, w, c) order, as the NHWC
reshape does, and run fc6 and fc7 (4096 wide, ReLU) with dropout 0.5 after
each ReLU when the caller passes a dropout generator (the train step of a VGG
head does; predict never does), which mirrors flax's ``has_rng("dropout")``.
fc6's input width P * P * C must be known when the head is built (flax infers
it at init): 6 * 6 * 256 = 9216 for the dock recipe.  A dropped unit is 0 and
a kept one is doubled (x / 0.5), as ``nn.Dropout`` does; the mask is drawn by
``torch.rand`` from the generator given (``F.dropout`` takes none), so it is
not unit_tpu's threefry mask.

``InceptionResNetHead`` is the full InceptionResNetV2 tail: ``mixed_7a``
(stride-2 unpadded branches and a max pool: 17x17 -> 8x8, 14x14 -> 6x6, to
992 + C channels, 2080 over block17's 1088), 9 x Block8 at scale 0.2, a final
Block8 at scale 1 without ReLU, ``conv2d_7b`` 1x1 to 1536 and the spatial
mean.  Its branch convolutions have no bias; each Block8's ``up`` has one.
Layout, precision and names as in models/backbones.py; the output is f32,
the mean summed in f32 from the compute dtype and rounded back to it first,
as ``jnp.mean`` of a bf16 map is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import Registry
from .resnet import Conv2d, Res5, lecun_normal_

# MODEL.ROI_BOX_HEAD.NAME -> constructor.  Res5BoxHeadNOTE differs from
# Res5BoxHead only in the reference's torch in-channel bookkeeping, and ""
# is the defaults' placeholder
BOX_HEAD_REGISTRY = Registry("BOX_HEAD")


class _Block8(nn.Module):
    """Inception-ResNet-C (1x1 and 1x3 + 3x1 branches):
    x + scale * up(branches), then ReLU unless ``relu`` is False."""

    def __init__(self, channels: int, scale: float = 0.2, relu: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.scale, self.relu = scale, relu
        self.b0 = Conv2d(channels, 192, 1, **kw)
        self.b1_0 = Conv2d(channels, 192, 1, **kw)
        self.b1_1 = Conv2d(192, 224, (1, 3), padding=(0, 1), **kw)
        self.b1_2 = Conv2d(224, 256, (3, 1), padding=(1, 0), **kw)
        self.up = Conv2d(448, channels, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = F.relu(self.b0(x))
        b1 = F.relu(self.b1_2(F.relu(self.b1_1(F.relu(self.b1_0(x))))))
        x = x + self.scale * self.up(torch.cat([b0, b1], 1))
        return F.relu(x) if self.relu else x


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Units kept with probability 1 - ``rate`` (uniform draws from
    ``generator``) and divided by it; the others are zero."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Linear(nn.Module):
    """flax ``nn.Dense`` in ``dtype``: f32 weight [out, in] (lecun_normal) and
    bias (zero), both cast with the input to ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(lecun_normal_(torch.empty(out_features, in_features),
                                                 in_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class TwoFC(nn.Module):
    """fc6 and fc7, each followed by ReLU and, given a generator, dropout."""

    def __init__(self, in_features: int, fc_dim: int = 4096, rate: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.fc6 = Linear(in_features, fc_dim, dtype, generator)
        self.fc7 = Linear(fc_dim, fc_dim, dtype, generator)

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for fc in (self.fc6, self.fc7):
            x = F.relu(fc(x))
            if dropout_generator is not None:
                x = dropout(x, self.rate, dropout_generator)
        return x


class VGGFCHead(nn.Module):
    """[N, P, P, C] -> flattened in (h, w, c) order -> fc6/fc7 -> [N, 4096] f32."""

    def __init__(self, in_channels: int, pooler_resolution: int, fc_dim: int = 4096,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = TwoFC(pooler_resolution * pooler_resolution * in_channels, fc_dim,
                        dtype=dtype, generator=generator)
        self.out_channels = fc_dim

    def forward(self, x: torch.Tensor, spatial_mean: bool = True,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not spatial_mean:
            raise ValueError(f"{type(self).__name__} has no spatial map: fc6 flattens each "
                             "ROI, so there is no map to keep (a mask head cannot read it)")
        return self.fc(x.reshape(x.shape[0], -1), dropout_generator).to(torch.float32)


class InceptionResNetHead(nn.Module):
    """mixed_7a -> ``num_block8`` x Block8(0.2) -> Block8(1.0, no ReLU) ->
    conv2d_7b -> spatial mean: [N, P, P, C] -> [N, 1536] f32."""

    def __init__(self, in_channels: int = 1088, num_block8: int = 9,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.dtype = dtype
        self.num_block8 = num_block8
        self.m7a_b0_0 = Conv2d(in_channels, 256, 1, **kw)
        self.m7a_b0_1 = Conv2d(256, 384, 3, stride=2, **kw)
        self.m7a_b1_0 = Conv2d(in_channels, 256, 1, **kw)
        self.m7a_b1_1 = Conv2d(256, 288, 3, stride=2, **kw)
        self.m7a_b2_0 = Conv2d(in_channels, 256, 1, **kw)
        self.m7a_b2_1 = Conv2d(256, 288, 3, padding=1, **kw)
        self.m7a_b2_2 = Conv2d(288, 320, 3, stride=2, **kw)
        width = 384 + 288 + 320 + in_channels
        for i in range(num_block8):
            self.add_module(f"block8_{i}", _Block8(width, 0.2, **kw))
        self.block8_final = _Block8(width, 1.0, relu=False, **kw)
        self.conv2d_7b = Conv2d(width, 1536, 1, **kw)
        self.out_channels = 1536

    def forward(self, x: torch.Tensor, spatial_mean: bool = True) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        b0 = F.relu(self.m7a_b0_1(F.relu(self.m7a_b0_0(x))))
        b1 = F.relu(self.m7a_b1_1(F.relu(self.m7a_b1_0(x))))
        b2 = F.relu(self.m7a_b2_2(F.relu(self.m7a_b2_1(F.relu(self.m7a_b2_0(x))))))
        x = torch.cat([b0, b1, b2, F.max_pool2d(x, 3, 2)], 1)
        for i in range(self.num_block8):
            x = getattr(self, f"block8_{i}")(x)
        x = F.relu(self.conv2d_7b(self.block8_final(x)))
        x = x.mean(dim=(2, 3)) if spatial_mean else x.permute(0, 2, 3, 1)
        return x.to(torch.float32)


def build_res5_box_head(in_channels: int, depth: int = 50, res2_out_channels: int = 256,
                        dtype: torch.dtype = torch.float32,
                        generator: Optional[torch.Generator] = None, **_) -> Res5:
    return Res5(depth=depth, res2_out_channels=res2_out_channels, in_channels=in_channels,
                dtype=dtype, generator=generator)


def build_inception_resnet_head(in_channels: int, dtype: torch.dtype = torch.float32,
                                generator: Optional[torch.Generator] = None,
                                **_) -> InceptionResNetHead:
    return InceptionResNetHead(in_channels, dtype=dtype, generator=generator)


def build_vgg_fc_head(in_channels: int, pooler_resolution: int = 7,
                      dtype: torch.dtype = torch.float32,
                      generator: Optional[torch.Generator] = None, **_) -> VGGFCHead:
    return VGGFCHead(in_channels, pooler_resolution, dtype=dtype, generator=generator)


for _name in ("Res5BoxHead", "Res5BoxHeadWithMask", "Res5BoxHeadNOTE", ""):
    BOX_HEAD_REGISTRY.register(build_res5_box_head, name=_name)
BOX_HEAD_REGISTRY.register(build_inception_resnet_head, name="InceptionResNetHead")
for _name in ("VGGConvFCHead", "VGGCNNFBoxHead"):
    BOX_HEAD_REGISTRY.register(build_vgg_fc_head, name=_name)

# the heads that take a dropout generator in training
VGG_HEADS = ("VGGConvFCHead", "VGGCNNFBoxHead")


def build_box_head(name: str, in_channels: int, depth: int = 50,
                   res2_out_channels: int = 256, pooler_resolution: int = 14,
                   dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """The box head MODEL.ROI_BOX_HEAD.NAME names, over ``in_channels``
    pooled channels at ``pooler_resolution`` (the VGG heads' fc6 width); it
    has ``out_channels``."""
    return BOX_HEAD_REGISTRY.get(name)(in_channels, depth=depth,
                                       res2_out_channels=res2_out_channels,
                                       pooler_resolution=pooler_resolution, dtype=dtype,
                                       generator=generator)
