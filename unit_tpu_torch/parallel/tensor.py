"""Tensor parallelism: column-parallel forms of the layers ``mesh.tp_shard`` splits.

The counterpart of unit_tpu's TP mode (unit_tpu/parallel/mesh.py:116-156),
where GSPMD splits every large kernel's output channels over the ``model``
mesh axis and places the collectives itself.  Here each split layer says
where its collectives go (Megatron's column-parallel layer):

  * in front of it, ``copy_to_model``: the identity forward; backward, the
    input gradient (this rank's output channels' share) summed over the
    model group;
  * the layer itself on this rank's slice of the kernel and of its bias
    (out channels ``[r * O / M, (r + 1) * O / M)``);
  * after it, ``gather_from_model``: forward, the ranks' output channels
    gathered into the whole output; backward, this rank's slice of the
    output gradient.

So everything outside a split layer is whole and every model rank computes
it alike: the epilogues (K4), ROIAlign (K1, K2) and the NMS (K3) see the
tensors they see in one process.  A split kernel's bias is split with it
(unit_tpu leaves the bias replicated and lets GSPMD reshard around it: the
same values).  Each split parameter carries ``tp_shard = (dim, rank,
ranks)``: its dim in the torch layout, this rank's part and the number of
parts, and ``tp_group``, the model group it is split over;
``mesh.full_tensor``, ``mesh.load_full_`` and the clip's norm read them.

Over gloo (ranks sharing one card) each of these collectives stages the CUDA
tensor through the host inside gloo; over NCCL it stays on the cards.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch import nn

from ..models.box_heads import Linear
from ..models.mask_head import Deconv2d
from ..models.resnet import Conv2d


def _dense_last(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with ``dim`` moved last, contiguous (a view for a channels_last
    map and its channel dim)."""
    return t.movedim(dim, -1).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.preserve_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        local = _dense_last(y, dim)
        parts: List[torch.Tensor] = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        ctx.dim, ctx.start, ctx.size = dim, r * y.shape[dim], y.shape[dim]
        return torch.cat(parts, dim=-1).movedim(-1, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.size), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (whole on every model rank); its gradient summed over ``group``."""
    return _CopyToModel.apply(x, group)


def gather_from_model(y: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The model ranks' parts of ``y`` along ``dim``, in rank order; the
    gradient of this rank's part is its slice of the whole gradient."""
    return _GatherFromModel.apply(y, group, dim)


def _split(param: torch.Tensor, dim: int, group) -> nn.Parameter:
    rank, ranks = dist.get_rank(group), dist.get_world_size(group)
    size = param.shape[dim] // ranks
    part = nn.Parameter(param.detach().narrow(dim, rank * size, size).clone(),
                        requires_grad=param.requires_grad)
    part.tp_shard = (dim, rank, ranks)
    part.tp_group = group
    return part


class _ColumnParallel:
    """Mixin: the layer on this rank's output channels, between the two
    collectives.  ``weight_dim``: the weight's output-channel dim;
    ``out_dim``: the output's."""

    weight_dim, out_dim = 0, 1

    def __init__(self, layer: nn.Module, group):
        """The part of ``layer`` (its whole form, whose attributes it takes)
        that this rank of ``group`` holds."""
        nn.Module.__init__(self)
        self.group = group
        for k, v in vars(layer).items():  # stride, padding, dtype, ...
            if not k.startswith("_") and k != "training":
                setattr(self, k, v)
        self.weight = _split(layer.weight, self.weight_dim, group)
        self.bias = None if layer.bias is None else _split(layer.bias, 0, group)
        self.train(layer.training)

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        y = super().forward(copy_to_model(x, self.group), *args, **kwargs)
        return gather_from_model(y, self.group, self.out_dim)


class ColumnParallelConv2d(_ColumnParallel, Conv2d):
    """``models.resnet.Conv2d`` on its rank's output channels ([O/M, I, kh, kw])."""


class ColumnParallelLinear(_ColumnParallel, Linear):
    """``models.box_heads.Linear`` on its rank's outputs ([out/M, in])."""

    out_dim = -1


class ColumnParallelDeconv2d(_ColumnParallel, Deconv2d):
    """The mask head's ``Deconv2d`` on its rank's output channels
    ([in, out/M, kh, kw])."""

    weight_dim = 1


# the layers tensor parallelism splits, and their column-parallel forms
COLUMN_PARALLEL = {Conv2d: ColumnParallelConv2d, Linear: ColumnParallelLinear,
                   Deconv2d: ColumnParallelDeconv2d}


__all__ = ["COLUMN_PARALLEL", "ColumnParallelConv2d", "ColumnParallelDeconv2d",
           "ColumnParallelLinear", "copy_to_model", "gather_from_model"]
