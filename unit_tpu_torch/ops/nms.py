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

Every function takes one image ([N, 4] boxes) or a batch ([B, N, 4]): the
batch is unit_tpu's ``vmap`` written out, one kernel launch for all images.
``nms_sorted_mask_survivor_plain`` is the kernel's algorithm (a buffer of the
survivors so far, tiles of 64 candidates) in plain PyTorch: its specification.
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


def _stack_masks(masks, sorted_boxes: torch.Tensor) -> torch.Tensor:
    """Per-image keep masks of a [B, N, 4] batch -> [B, N] (B may be 0)."""
    if not masks:
        return torch.zeros(sorted_boxes.shape[:2], dtype=torch.bool, device=sorted_boxes.device)
    return torch.stack(masks)


def nms_sorted_mask_plain(
    sorted_boxes: torch.Tensor,
    iou_threshold: float,
    max_keep: Optional[int] = None,
    tile_size: int = 512,
) -> torch.Tensor:
    """Plain PyTorch greedy NMS keep mask over score-sorted boxes [N, 4], or
    over each image of [B, N, 4] -> [B, N]."""
    if sorted_boxes.dim() == 3:
        return _stack_masks(
            [nms_sorted_mask_plain(image, iou_threshold, max_keep, tile_size)
             for image in sorted_boxes], sorted_boxes)
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


def kernel_pair_hits(boxes1, area1, boxes2, area2, iou_threshold: float) -> torch.Tensor:
    """[M, T] bool: IoU(boxes1[m], boxes2[t]) > thr, decided as the CUDA
    kernel decides it, in three steps that never change the answer of
    ``pairwise_iou(boxes1, boxes2) > thr``:

    1. for thr >= 0 a pair whose intersection is empty is no hit (IoU 0);
    2. for thr >= 0, IoU > thr only if inter > 0.999 thr max(area): inter
       <= min(area) and union >= max(area), and 0.1% is far more than every
       rounding on the way; a bound that needs no union and no division;
    3. the exact test without the division: rounding is monotone, so
       rn(inter / union) > thr iff inter / union lies above the midpoint of
       thr and the next float32 after it, or on it when that tie rounds up
       (thr's last mantissa bit odd).  union * midpoint is exact in float64
       (24 + 25 significant bits).
    """
    thr = torch.tensor(iou_threshold, dtype=torch.float32)
    above = torch.nextafter(thr, torch.tensor(float("inf")))
    mid = 0.5 * (thr.double() + above.double())
    tie_up = bool(thr.view(torch.int32) & 1)
    wh = (torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
          - torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2]))
    iw, ih = wh[..., 0], wh[..., 1]
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    union = area1[:, None] + area2[None, :] - inter
    lhs, rhs = inter.double(), union.double() * mid.to(union.device)
    over = (lhs > rhs) | (lhs == rhs if tie_up else torch.zeros_like(lhs, dtype=torch.bool))
    over = torch.where(union > 0, over, torch.full_like(over, 0.0 > iou_threshold))
    if iou_threshold >= 0:
        thr_low = (torch.tensor(0.999, dtype=torch.float32) * thr).to(area1.device)
        bound = inter > torch.maximum((thr_low * area1)[:, None], (thr_low * area2)[None, :])
        over &= (torch.minimum(iw, ih) > 0) & bound
    return over


def nms_sorted_mask_survivor_plain(
    sorted_boxes: torch.Tensor,
    iou_threshold: float,
    max_keep: Optional[int] = None,
    tile: int = 64,
    n_valid=None,
    kernel_arithmetic: bool = True,
) -> torch.Tensor:
    """The survivor-buffer greedy NMS of unit_tpu's ``_nms_sorted_mask_capped``
    (ops/nms.py:115-153), step by step as the CUDA kernel runs it: the
    kernel's specification, in a form that runs on the CPU.

    Tiles of ``tile`` boxes in score order.  A tile is tested against the at
    most ``max_keep`` survivors kept so far, then resolved inside the tile in
    order (an alive box removes the later boxes of the tile it overlaps), and
    its keeps are appended to the buffer.  The walk stops when ``max_keep``
    boxes are kept or the tile starts at or after ``n_valid`` (rows from
    there on are empty by contract: they are not read); keeps past the cap
    inside the last tile are cut.  A pair is tested by ``kernel_pair_hits``
    (the kernel's shortcuts and its division-free threshold test), or with
    ``kernel_arithmetic=False`` by ``pairwise_iou(...) > thr`` itself, for
    the tests that the shortcuts change no mask.  Returns the mask of
    ``nms_sorted_mask_plain``.

    sorted_boxes [N, 4] or [B, N, 4]; n_valid an int, or [B] ints or tensor.
    """
    if sorted_boxes.dim() == 3:
        counts = [None] * sorted_boxes.shape[0] if n_valid is None else [int(v) for v in n_valid]
        return _stack_masks(
            [nms_sorted_mask_survivor_plain(image, iou_threshold, max_keep, tile, count,
                                            kernel_arithmetic)
             for image, count in zip(sorted_boxes, counts)], sorted_boxes)
    n = sorted_boxes.shape[0]
    cap = n if max_keep is None else max(0, min(int(max_keep), n))
    end = n if n_valid is None else max(0, min(int(n_valid), n))
    keep = torch.zeros((n,), dtype=torch.bool, device=sorted_boxes.device)
    buf = torch.zeros((cap, 4), dtype=sorted_boxes.dtype, device=sorted_boxes.device)
    buf_area = torch.zeros((cap,), dtype=sorted_boxes.dtype, device=sorted_boxes.device)
    kept = 0

    def hits(boxes1, area1, boxes2, area2):
        if kernel_arithmetic:
            return kernel_pair_hits(boxes1, area1, boxes2, area2, iou_threshold)
        return box_ops.pairwise_iou(boxes1, boxes2) > iou_threshold

    for start in range(0, end, tile):
        if kept >= cap:
            break
        cand = sorted_boxes[start:min(start + tile, end)]
        cand_area = box_ops.area(cand)
        alive = box_ops.nonempty(cand)
        # against the survivors so far
        alive &= ~hits(buf[:kept], buf_area[:kept], cand, cand_area).any(dim=0)
        # inside the tile, in order: only rows that overlap a later box take a turn
        inside = hits(cand, cand_area, cand, cand_area).triu(1)
        for k in inside.any(dim=1).nonzero()[:, 0].tolist():
            if alive[k]:
                alive &= ~inside[k]
        rows = alive.nonzero()[:, 0][:cap - kept]  # keeps past the cap-th are cut
        keep[start + rows] = True
        buf[kept:kept + rows.numel()] = cand[rows]
        buf_area[kept:kept + rows.numel()] = cand_area[rows]
        kept += rows.numel()
    return keep


def nms_sorted_mask(
    sorted_boxes: torch.Tensor,
    iou_threshold: float,
    max_keep: Optional[int] = None,
    impl: str = "auto",
    n_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatching keep mask (see the module docstring for ``impl``) over
    [N, 4] -> [N] or [B, N, 4] -> [B, N].  ``n_valid`` ([B] int32, the
    kernel's hint): rows at or after it are all-zero boxes.  "auto", and
    "cuda" on a CUDA tensor, go through the registered operator
    ``library.nms_keep`` (K3 on the card, the plain version on the CPU),
    which ``torch.export`` can trace."""
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown NMS impl {impl!r} (auto | cuda | plain)")
    if impl == "plain":
        return nms_sorted_mask_plain(sorted_boxes, iou_threshold, max_keep)
    if impl == "cuda" and not sorted_boxes.is_cuda:
        return nms_sorted_mask_cuda(sorted_boxes, iou_threshold, max_keep, n_valid=n_valid)
    single = sorted_boxes.dim() == 2
    boxes = sorted_boxes[None] if single else sorted_boxes
    n = boxes.shape[1]
    cap = n if max_keep is None else max(0, min(int(max_keep), n))
    keep = library.nms_keep(boxes, n_valid, float(iou_threshold), cap)
    return keep[0] if single else keep


def _take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values [B, N] or [B, N, 4] at index [B, K] along dimension 1."""
    if values.dim() == 3:
        index = index[..., None].expand(-1, -1, values.shape[2])
    return torch.gather(values, 1, index)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS -> (indices [min(N, max_out)] into the input, valid mask),
    kept boxes first in descending score order (unit_tpu ops/nms.py:156-185).

    With a leading image dimension (boxes [B, N, 4], scores and valid [B, N])
    every image is suppressed on its own, in one kernel launch, and the
    outputs are [B, min(N, max_out)]: unit_tpu's ``vmap`` written out."""
    if boxes.dim() == 2:
        idx, ok = nms(boxes[None], scores[None], iou_threshold, max_out,
                      None if valid is None else valid[None], impl)
        return idx[0], ok[0]
    n = boxes.shape[1]
    s = scores if valid is None else torch.where(valid, scores, _NEG_INF)
    # stable, like jnp.argsort: ties and padding slots come out the same
    order = torch.argsort(-s, dim=1, stable=True)
    sorted_valid = _take(s, order) > _NEG_INF / 2
    sorted_boxes = torch.where(sorted_valid[..., None], _take(boxes, order), 0.0).contiguous()
    # invalid rows are zeroed and sorted to the tail: nothing at or after
    # row n_valid[b] can be kept or suppress (counted on the device)
    n_valid = sorted_valid.sum(dim=1, dtype=torch.int32)
    keep_sorted = (
        nms_sorted_mask(sorted_boxes, iou_threshold, max_keep=max_out, impl=impl,
                        n_valid=n_valid)
        & sorted_valid
    )
    ar = torch.arange(n, device=boxes.device)
    slot_key = torch.where(keep_sorted, ar, n + 1)
    take = torch.argsort(slot_key, dim=1, stable=True)[:, :max_out]
    return _take(order, take), _take(keep_sorted, take)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS by the coordinate-offset trick (ops/nms.py:188-203);
    like :func:`nms` it takes one image or a batch ([B, N, ...], idxs [B, N]),
    each image with its own offset."""
    masked = boxes if valid is None else torch.where(valid[..., None], boxes, 0.0)
    max_coord = masked.amax(dim=(-2, -1))
    offsets = idxs.to(boxes.dtype) * (max_coord[..., None] + 1.0)
    shifted = boxes + offsets[..., None]
    return nms(shifted, scores, iou_threshold, max_out, valid=valid, impl=impl)


# the registered operator calls back into this module (a cycle: imported last)
from . import library  # noqa: E402
