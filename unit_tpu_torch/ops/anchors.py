"""Anchor generation (port of unit_tpu/ops/anchors.py).

Anchors are computed in numpy exactly as unit_tpu computes them and moved to
the requested device, so both packages start from identical coordinates.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """[A, 4] XYXY anchors centred at (0, 0): w = sqrt(size^2 / ar), h = ar * w."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


@functools.lru_cache(maxsize=16)
def _grid_anchors_np(feat_h, feat_w, stride, sizes, aspect_ratios) -> np.ndarray:
    base = cell_anchors(sizes, aspect_ratios)
    shift_x = np.arange(feat_w, dtype=np.float32) * stride
    shift_y = np.arange(feat_h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)
    anchors = shifts[:, :, None, :] + base[None, None, :, :]
    anchors = anchors.reshape(-1, 4)
    anchors.setflags(write=False)
    return anchors


def grid_anchors(
    feat_h: int,
    feat_w: int,
    stride: int,
    sizes: Sequence[float],
    aspect_ratios: Sequence[float],
    device=None,
) -> torch.Tensor:
    """[feat_h * feat_w * A, 4] anchors in (y, x, anchor) row-major order, the
    (H, W, A) layout of the RPN head's predictions."""
    anchors = _grid_anchors_np(int(feat_h), int(feat_w), int(stride), tuple(sizes),
                               tuple(aspect_ratios))
    return torch.tensor(anchors, device=device)
