"""Static-shape random subsampling of labelled proposals and anchors.

Port of unit_tpu/ops/sampling.py.  Dynamic-size index selection becomes
rank-based masking: elements are ranked by a random key within their group
and the first ``target`` ranks are selected, so every output shape is static.
The random keys come from an explicit ``torch.Generator`` (jax.random keys in
unit_tpu): the two packages draw different numbers from the same seed, so
the tests compare them where sampling keeps every candidate and by
properties elsewhere.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..structures import boxes as box_ops
from ..structures.instances import GTInstances, SampledProposals
from . import matcher as matcher_ops


def _group_rank(score: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """0-based rank of each member among the members, by ``score``
    descending (stable); non-members get rank 2**30."""
    keyed = torch.where(member, score, torch.finfo(torch.float32).min)
    order = torch.argsort(-keyed, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return torch.where(member, rank, 1 << 30)


def subsample_label_masks(
    generator: Optional[torch.Generator],
    is_pos: torch.Tensor,
    is_neg: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select at most ``num_samples`` elements, at most ``positive_fraction``
    of them positive, uniformly at random within each group (detectron2's
    subsample_labels): returns (pos_selected, neg_selected) masks."""
    rnd = torch.rand(is_pos.shape, generator=generator, device=is_pos.device)
    num_pos = is_pos.sum().clamp_max(int(num_samples * positive_fraction))
    num_neg = torch.minimum(is_neg.sum(), num_samples - num_pos)
    pos_sel = _group_rank(rnd, is_pos) < num_pos
    neg_sel = _group_rank(rnd, is_neg) < num_neg
    return pos_sel, neg_sel


def label_and_sample_proposals(
    generator: Optional[torch.Generator],
    proposal_boxes: torch.Tensor,  # [P, 4]
    proposal_valid: torch.Tensor,  # [P]
    gt: GTInstances,               # one image: [G, 4], [G], [G]
    num_samples: int,
    positive_fraction: float,
    num_classes: int,
    iou_thresholds: Sequence[float] = (0.5,),
    iou_labels: Sequence[int] = (0, 1),
    append_gt: bool = True,
) -> SampledProposals:
    """Match one image's proposals to its GT and sample slots for the box head.

    GT boxes are appended as proposals (PROPOSAL_APPEND_GT); foreground takes
    its matched gt class, background ``num_classes``, ignored -1; then up to
    ``num_samples`` are drawn with at most ``positive_fraction`` foreground.
    The output has min(num_samples, P + G) slots: selected foreground first,
    then selected background, then unselected padding, each in index order.
    """
    if append_gt:
        all_boxes = torch.cat([proposal_boxes, gt.boxes], dim=0)
        all_valid = torch.cat([proposal_valid, gt.valid], dim=0)
    else:
        all_boxes, all_valid = proposal_boxes, proposal_valid

    iou = box_ops.pairwise_iou(gt.boxes, all_boxes)
    m = matcher_ops.match(iou, gt.valid, iou_thresholds, iou_labels, False)

    matched_classes = torch.where(gt.valid.any(), gt.classes.long()[m.matches], num_classes)
    gt_classes = torch.where(m.labels == 1, matched_classes, num_classes)
    gt_classes = torch.where(m.labels == -1, -1, gt_classes)
    gt_classes = torch.where(all_valid, gt_classes, -1)

    is_fg = (gt_classes >= 0) & (gt_classes < num_classes)
    is_bg = gt_classes == num_classes
    pos_sel, neg_sel = subsample_label_masks(generator, is_fg, is_bg, num_samples,
                                             positive_fraction)
    selected = pos_sel | neg_sel

    # exactly min(num_samples, n) slots: fg first, then bg, then the rest,
    # ties broken by index (unit_tpu's float keys order the same way)
    n = all_boxes.shape[0]
    idx = torch.arange(n, device=all_boxes.device)
    group = (~selected).long() * 2 + (~pos_sel).long()
    order = torch.argsort(group * n + idx)[:num_samples]
    slot_valid = selected[order]

    s_classes = torch.where(slot_valid, gt_classes[order], num_classes)
    return SampledProposals(
        boxes=all_boxes[order],
        gt_classes=s_classes,
        gt_boxes=gt.boxes[m.matches][order],
        valid=slot_valid,
        is_fg=is_fg[order] & slot_valid,
        gt_index=m.matches[order],
    )
