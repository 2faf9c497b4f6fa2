"""Non-maximum suppression with static output shapes.

Port of unit_tpu/ops/nms.py.  ``nms_sorted_mask`` dispatches between the
hand-written CUDA kernel (``nms_cuda.nms_sorted_mask_cuda``, K3) and its plain
PyTorch version ``nms_sorted_mask_plain``, the tiled fixed-point greedy of
unit_tpu/ops/nms.py:35-112:

    impl="auto"   kernel for a CUDA tensor, plain version for a CPU tensor
    impl="cuda"   kernel; raises for a CPU tensor
    impl="plain"  plain version (tests and chip_smoke.py's comparisons)

Both return the keep mask of full greedy NMS (suppress iff IoU > thr,
strictly; zero-area boxes never kept and never suppress), cut after the first
``max_keep`` keeps: the only part any caller consumes (ops/nms.py:69-81 of
unit_tpu proves those keeps equal the uncut algorithm's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..structures import boxes as box_ops
from .nms_cuda import nms_sorted_mask_cuda

_NEG_INF = -1e30


def _self_suppress(tile: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Within-tile greedy fixed point: alive mask (zero-area rows never live)."""
    t = tile.shape[0]
    iou_tile = box_ops.pairwise_iou(tile, tile)
    tri = torch.ones((t, t), dtype=torch.bool, device=tile.device).triu(1)
    supp = (torch.where(tri, iou_tile, 0.0) > iou_threshold).to(torch.float32)
    alive0 = box_ops.nonempty(tile)
    alive = alive0
    for _ in range(t):
        hit = (alive.to(torch.float32) @ supp) > 0.0
        new = alive0 & ~hit
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def nms_sorted_mask_plain(
    sorted_boxes: torch.Tensor,
    iou_threshold: float,
    max_keep: Optional[int] = None,
    tile_size: int = 512,
) -> torch.Tensor:
    """Plain PyTorch greedy NMS keep mask over score-sorted boxes [N, 4]."""
    n = sorted_boxes.shape[0]
    cap = n if max_keep is None else max(0, min(int(max_keep), n))
    keep = torch.zeros((n,), dtype=torch.bool, device=sorted_boxes.device)
    state = sorted_boxes.clone()
    kept = 0
    t = max(1, min(tile_size, n))
    for start in range(0, n, t):
        if kept >= cap:
            break
        tile = state[start:start + t]
        if start > 0:
            # surviving earlier boxes (suppressed ones are zeroed: IoU 0)
            iou_prev = box_ops.pairwise_iou(state[:start], tile)
            dead = (iou_prev > iou_threshold).any(dim=0)
            tile = torch.where(dead[:, None], 0.0, tile)
        alive = _self_suppress(tile, iou_threshold)
        state[start:start + t] = torch.where(alive[:, None], tile, 0.0)
        keep[start:start + t] = alive
        kept += int(alive.sum())
    if kept > cap:  # drop keeps past the cap-th (they are never consumed)
        keep &= torch.cumsum(keep.to(torch.int64), 0) <= cap
    return keep


def nms_sorted_mask(
    sorted_boxes: torch.Tensor,
    iou_threshold: float,
    max_keep: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching keep mask (see the module docstring for ``impl``)."""
    if impl == "auto":
        impl = "cuda" if sorted_boxes.is_cuda else "plain"
    if impl == "cuda":
        return nms_sorted_mask_cuda(sorted_boxes, iou_threshold, max_keep)
    if impl == "plain":
        return nms_sorted_mask_plain(sorted_boxes, iou_threshold, max_keep)
    raise ValueError(f"unknown NMS impl {impl!r} (auto | cuda | plain)")


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS -> (indices [min(N, max_out)] into the input, valid mask),
    kept boxes first in descending score order (unit_tpu ops/nms.py:156-185)."""
    n = boxes.shape[0]
    s = scores if valid is None else torch.where(valid, scores, _NEG_INF)
    # stable, like jnp.argsort: ties and padding slots come out the same
    order = torch.argsort(-s, stable=True)
    sorted_boxes = boxes[order]
    sorted_valid = s[order] > _NEG_INF / 2
    sorted_boxes = torch.where(sorted_valid[:, None], sorted_boxes, 0.0).contiguous()
    keep_sorted = (
        nms_sorted_mask(sorted_boxes, iou_threshold, max_keep=max_out, impl=impl)
        & sorted_valid
    )
    ar = torch.arange(n, device=boxes.device)
    slot_key = torch.where(keep_sorted, ar, n + 1)
    take = torch.argsort(slot_key, stable=True)[:max_out]
    return order[take], keep_sorted[take]


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS by the coordinate-offset trick (ops/nms.py:188-203)."""
    masked = boxes if valid is None else torch.where(valid[:, None], boxes, 0.0)
    max_coord = masked.max()
    offsets = idxs.to(boxes.dtype) * (max_coord + 1.0)
    shifted = boxes + offsets[:, None]
    return nms(shifted, scores, iou_threshold, max_out, valid=valid, impl=impl)
