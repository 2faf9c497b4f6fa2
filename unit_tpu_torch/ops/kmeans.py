"""Exact 1-D k-means on the device (globally optimal, deterministic).

Port of unit_tpu/ops/kmeans.py, which picks PCL's top-ranking proposal
cluster inside the train step.  In 1-D the optimal clusters are contiguous
intervals of the sorted values, so the global optimum is a contiguous-partition
dynamic program over weighted prefix sums: no initialisation, no host sync,
O(k N^2) elementwise work over [N+1, N+1] grids.

Every function takes one row ([N]) or a batch of rows ([R, N]) that are
clustered independently (unit_tpu's ``vmap`` written out).  The tie rules
are unit_tpu's: a stable sort of the values, the first minimum of the DP and
the first maximum of the centers.  f32 interval costs ``c2 - cs^2 / cw``
cancel, so where two partitions are within rounding of each other the
argmin may differ between XLA and PyTorch; the optimum's cost does not.
"""

from __future__ import annotations

from typing import Tuple

import torch


def kmeans_1d(values: torch.Tensor, valid: torch.Tensor,
              k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Globally optimal 1-D k-means of the valid entries of each row.

    values, valid [..., N] -> (assignments [..., N] int64, centers [..., k]):
    invalid entries get assignment -1, empty clusters center -inf; cluster
    ids are in ascending center order (clusters are sorted-value intervals).
    """
    if values.dim() == 1:
        assign, centers = kmeans_1d(values[None], valid[None], k)
        return assign[0], centers[0]
    lead, n = values.shape[:-1], values.shape[-1]
    values, valid = values.reshape(-1, n), valid.reshape(-1, n)
    r, dtype = values.shape[0], values.dtype
    big = torch.finfo(dtype).max
    # sort by value; invalid entries go to the tail with weight 0, so they
    # add nothing to any interval's cost
    order = torch.argsort(torch.where(valid, values, big), dim=-1, stable=True)
    xs = torch.where(valid, values, 0.0).gather(-1, order)
    ws = valid.to(dtype).gather(-1, order)
    zero = values.new_zeros((r, 1))
    w_sum = torch.cat([zero, ws.cumsum(-1)], -1)            # [R, N+1]
    s1 = torch.cat([zero, (ws * xs).cumsum(-1)], -1)
    s2 = torch.cat([zero, (ws * xs * xs).cumsum(-1)], -1)

    # [R, i, j]: the interval [i, j) of sorted positions
    cw = w_sum[:, None, :] - w_sum[:, :, None]
    cs = s1[:, None, :] - s1[:, :, None]
    c2 = s2[:, None, :] - s2[:, :, None]
    cost = (c2 - cs * cs / cw.clamp_min(1e-12)).clamp_min(0.0)
    idx = torch.arange(n + 1, device=values.device)
    cost = torch.where(idx[:, None] <= idx[None, :], cost, float("inf"))

    # DP over the number of clusters: best[j] is the least cost of covering
    # [0, j) with m + 1 intervals, arg[j] the start of the last one
    best = cost[:, 0]
    args = []
    for _ in range(k - 1):
        best, arg = (best[:, :, None] + cost).min(dim=1)  # first minimum, as argmin
        args.append(arg)

    # backtrack the k - 1 boundaries from j = n
    bounds = []
    cur = torch.full((r, 1), n, dtype=torch.int64, device=values.device)
    for arg in reversed(args):
        cur = arg.gather(1, cur)
        bounds.append(cur)
    bounds = torch.cat(bounds[::-1], 1) if bounds else cur[:, :0]  # [R, k-1]

    pos = torch.arange(n, device=values.device)
    seg = (pos[None, None, :] >= bounds[:, :, None]).sum(1)  # [R, N] sorted positions
    full = torch.full((r, 1), n, dtype=torch.int64, device=values.device)
    starts = torch.cat([torch.zeros_like(full), bounds], 1)
    ends = torch.cat([bounds, full], 1)
    seg_w = w_sum.gather(1, ends) - w_sum.gather(1, starts)
    seg_s = s1.gather(1, ends) - s1.gather(1, starts)
    centers = torch.where(seg_w > 0, seg_s / seg_w.clamp_min(1e-12), float("-inf"))

    # back to input order: ``order`` is a permutation, so the scatter writes
    # every position once
    assign = torch.empty_like(seg).scatter_(1, order, seg)
    assign = torch.where(valid, assign, -1)
    return assign.reshape(*lead, n), centers.reshape(*lead, k)


def top_cluster_mask(values: torch.Tensor, valid: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Membership mask [..., N] of the cluster with the highest center
    (get_top_ranking_proposals).  Falls back to the argmax element when a row
    has fewer than k valid values or its top cluster is empty."""
    n_valid = valid.sum(-1, keepdim=True)
    assign, centers = kmeans_1d(values, valid, k)
    top = centers.argmax(-1, keepdim=True)
    mask = (assign == top) & valid
    best = torch.where(valid, values, float("-inf")).argmax(-1, keepdim=True)
    fallback = torch.arange(values.shape[-1], device=values.device) == best
    mask = torch.where(n_valid < k, fallback, mask)
    return torch.where(mask.any(-1, keepdim=True), mask, fallback)
