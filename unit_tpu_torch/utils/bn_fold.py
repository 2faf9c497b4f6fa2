"""Fold FrozenBN's scale into the preceding convolution's weight (inference).

Port of unit_tpu/utils/bn_fold.py:28-69 onto the module tree.  FrozenBN
applies ``y = x * s + t`` with ``s = weight / sqrt(var + eps)`` and
``t = bias - mean * s`` after every convolution; for a forward-only pass the
multiply folds into the weight once (``conv(x, W * s) + t``).  The module
graph is unchanged: each folded FrozenBN is rewritten to weight 1, mean 0,
var 1 - eps (so ``sqrt(var + eps)`` is exactly 1) and bias ``t``, and the
fused epilogue kernel still runs, with scale 1.

The fold is exact in real arithmetic; in floats it moves a rounding (the f32
weight is scaled before the cast to the compute dtype, instead of the f32
epilogue scaling the convolution's rounded output), so folded outputs differ
at bf16 resolution.  It is for evaluation only (``TPU.FOLD_BN_AT_EVAL``):
training differentiates through the unfolded weights.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..models.resnet import Conv2d, FrozenBN


def fold_frozen_bn(model: nn.Module) -> nn.Module:
    """A deep copy of ``model`` with every ``X`` / ``X_bn`` Conv2d + FrozenBN
    sibling pair folded; ``model`` itself is left as it is (it may be in
    training).  A FrozenBN without a conv sibling is left untouched."""
    folded = copy.deepcopy(model)
    with torch.no_grad():
        for parent in folded.modules():
            for name, bn in parent.named_children():
                conv = getattr(parent, name[: -len("_bn")], None) if name.endswith("_bn") else None
                if not (isinstance(bn, FrozenBN) and isinstance(conv, Conv2d)):
                    continue
                scale, shift = bn.scale_shift()
                conv.weight.mul_(scale.view(-1, 1, 1, 1))  # [O, I, k, k]: over dim 0
                bn.weight.fill_(1.0)
                bn.mean.zero_()
                bn.var.fill_(1.0 - bn.eps)
                bn.bias.copy_(shift)
    return folded
