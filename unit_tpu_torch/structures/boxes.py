"""Box geometry (XYXY, absolute coordinates) on plain ``[..., 4]`` tensors.

Port of unit_tpu/structures/boxes.py.  The op order of ``pairwise_iou`` is
the one the NMS kernel (csrc/nms_mask.cu) reproduces bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

# Detectron2 clamps dw/dh to log(1000 / 16) before exponentiation.
SCALE_CLAMP = math.log(1000.0 / 16.0)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of XYXY boxes; degenerate boxes get area 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    return w * h


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[..., M, N] intersection areas between two sets of XYXY boxes [..., M, 4]
    and [..., N, 4] (leading dimensions broadcast)."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[..., M, N] IoU; 0 where the union is empty (degenerate boxes)."""
    inter = pairwise_intersection(boxes1, boxes2)
    union = area(boxes1)[..., :, None] + area(boxes2)[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def clip_boxes(boxes: torch.Tensor, image_size: Tuple) -> torch.Tensor:
    """Clip XYXY boxes to [0, W] x [0, H]; ``image_size`` is (H, W): numbers,
    0-d tensors on the boxes' device, or [B, 1] tensors for boxes [B, N, 4]
    (each image its own size)."""
    h, w = (torch.as_tensor(v, dtype=boxes.dtype, device=boxes.device) for v in image_size)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    return torch.stack(
        [clip(boxes[..., 0], w), clip(boxes[..., 1], h),
         clip(boxes[..., 2], w), clip(boxes[..., 3], h)],
        dim=-1,
    )


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Boolean mask of boxes with both sides > threshold."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def get_deltas(
    src_boxes: torch.Tensor,
    target_boxes: torch.Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Box2BoxTransform.get_deltas, the inverse of :func:`apply_deltas`:
    (wx*dx, wy*dy, ww*log(tw/sw), wh*log(th/sh)); sides are floored at 1e-6,
    degenerate boxes give values the callers mask."""
    src_w = (src_boxes[..., 2] - src_boxes[..., 0]).clamp_min(1e-6)
    src_h = (src_boxes[..., 3] - src_boxes[..., 1]).clamp_min(1e-6)
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = (target_boxes[..., 2] - target_boxes[..., 0]).clamp_min(1e-6)
    tgt_h = (target_boxes[..., 3] - target_boxes[..., 1]).clamp_min(1e-6)
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    wx, wy, ww, wh = weights
    dx = wx * (tgt_cx - src_cx) / src_w
    dy = wy * (tgt_cy - src_cy) / src_h
    dw = ww * torch.log(tgt_w / src_w)
    dh = wh * torch.log(tgt_h / src_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: ``deltas`` [..., K*4] on ``boxes``
    [..., 4] -> [..., K*4], with dw/dh clamped to SCALE_CLAMP."""
    orig_shape = deltas.shape
    d4 = deltas.reshape(orig_shape[:-1] + (-1, 4))

    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    wx, wy, ww, wh = weights
    dx = d4[..., 0] / wx
    dy = d4[..., 1] / wy
    dw = (d4[..., 2] / ww).clamp_max(SCALE_CLAMP)
    dh = (d4[..., 3] / wh).clamp_max(SCALE_CLAMP)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack(
        [pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
         pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h],
        dim=-1,
    )
    return out.reshape(orig_shape)
