"""IoU matcher with masked (padded) ground truth.

Port of unit_tpu/ops/matcher.py: a pure function over a static-shape [M, N]
quality matrix and a validity mask of the padded GT rows.  Like the
reference's forked Matcher it also returns the per-prediction max quality
(``vals``), which the weak detector's fg/bg thresholds read.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class MatchResult(NamedTuple):
    matches: torch.Tensor  # [N] int64 index of the matched gt in [0, M)
    labels: torch.Tensor   # [N] int64 in {-1, 0, 1}
    vals: torch.Tensor     # [N] max match quality (0 without a valid gt)


def match(
    quality: torch.Tensor,
    gt_valid: torch.Tensor,
    thresholds: Sequence[float],
    labels: Sequence[int],
    allow_low_quality_matches: bool = False,
) -> MatchResult:
    """Match N predictions against M padded GT rows.

    quality [..., M, N] (>= 0, e.g. IoU); gt_valid [..., M]; ascending
    ``thresholds`` band the max quality into ``labels`` (len(thresholds) + 1
    values from {-1, 0, 1}); ``allow_low_quality_matches`` is the RPN rescue:
    every prediction tied with a valid gt's best quality gets label 1.
    Without a valid gt: matches 0, labels labels[0], vals 0.  Leading
    dimensions are independent problems (unit_tpu's ``vmap``).
    """
    assert len(labels) == len(thresholds) + 1
    masked_q = torch.where(gt_valid[..., :, None], quality, -1.0)
    matched_vals, matches = masked_q.max(dim=-2)  # first index among ties

    any_gt = gt_valid.any(dim=-1, keepdim=True)
    matched_vals = torch.where(any_gt, matched_vals.clamp_min(0.0), 0.0)
    matches = torch.where(any_gt, matches, 0)

    edges = [float("-inf")] + [float(t) for t in thresholds] + [float("inf")]
    out = torch.full_like(matches, labels[0])
    for lbl, low, high in zip(labels, edges[:-1], edges[1:]):
        out = torch.where((matched_vals >= low) & (matched_vals < high), lbl, out)

    if allow_low_quality_matches:
        highest_per_gt = masked_q.max(dim=-1).values
        is_best = (quality == highest_per_gt[..., None]) & gt_valid[..., :, None]
        out = torch.where(is_best.any(dim=-2), 1, out)

    out = torch.where(any_gt, out, labels[0])
    return MatchResult(matches=matches, labels=out, vals=matched_vals)
