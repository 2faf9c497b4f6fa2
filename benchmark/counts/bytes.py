"""Bytes an op must move at its boundary: each input it reads once, each
output it writes once, whatever implements it (a later fusion or swap
leaves these where they are)."""

from __future__ import annotations

import math
from typing import Sequence


def nbytes(shape: Sequence[int], itemsize: int) -> int:
    return math.prod(int(s) for s in shape) * int(itemsize)


def bn_act_forward_bytes(shape, itemsize: int, has_residual: bool) -> int:
    """The FrozenBN + residual + ReLU epilogue forward: x read, the residual
    read where there is one, the output written (scale and shift are [C])."""
    n = nbytes(shape, itemsize)
    return n * (3 if has_residual else 2)


def bn_act_backward_bytes(shape, itemsize: int, relu: bool, needs_dx: bool,
                          needs_dres: bool) -> int:
    """Its backward: the incoming gradient read, the saved output read for
    the ReLU's mask, each input gradient written."""
    n = nbytes(shape, itemsize)
    return n * (1 + int(relu) + int(needs_dx) + int(needs_dres))


def roi_align_backward_bytes(grad_shape, grad_itemsize: int, map_shape,
                             map_itemsize: int) -> int:
    """ROIAlign's backward: the incoming gradient [B, N, P, P, C] read, the
    map gradient [B, H, W, C] written."""
    return nbytes(grad_shape, grad_itemsize) + nbytes(map_shape, map_itemsize)
