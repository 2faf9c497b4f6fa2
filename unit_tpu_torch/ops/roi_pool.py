"""ROIPool (max) on [B, H, W, C] feature maps: the dock suite's pooler.

Port of unit_tpu/ops/roi_align.py:198-230 (``roi_pool_max``, XLA in unit_tpu,
not a Pallas kernel), taken over the batch.  A static-shape form of
torchvision's RoIPool: each ROI is scaled by ``spatial_scale`` and widened to
whole cells (floor of x1, y1, ceil of x2, y2, at least one cell a side);
each of its P x P bins takes the max of a fixed 2 x 2 grid of nearest-cell
samples, at fractions (i + 0.5) / (2P) of the ROI, clamped into the map.

The max is ``amax``: its gradient is split equally among tied samples, as
``jnp.max``'s is.  A bin narrower than a cell samples one cell two to four
times, so ties are the rule for small ROIs; each tied sample sends its share
back to the same cell.  The gather is an advanced index, whose backward is
``index_put_`` with accumulation: on CUDA a sort of the indices followed by
one ordered sum per cell, so the gradient is the same from run to run (no
atomics), summed in f32 for a bf16 map.  The pooled output keeps the
feature dtype.
"""

from __future__ import annotations

import torch

SAMPLES = 2  # samples a bin side


def roi_pool_max(features: torch.Tensor, rois: torch.Tensor, output_size: int = 7,
                 spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """features [B, H, W, C], rois [B, N, 4] (x1, y1, x2, y2 in image
    coordinates) -> [B, N, P, P, C] in the feature dtype."""
    b, h, w, c = features.shape
    n, p, s = rois.shape[1], output_size, SAMPLES
    r = rois.to(torch.float32)
    x1 = torch.floor(r[..., 0] * spatial_scale)
    y1 = torch.floor(r[..., 1] * spatial_scale)
    x2 = torch.ceil(r[..., 2] * spatial_scale)
    y2 = torch.ceil(r[..., 3] * spatial_scale)
    bw = (x2 - x1).clamp_min(1.0)
    bh = (y2 - y1).clamp_min(1.0)
    frac = (torch.arange(p * s, dtype=torch.float32, device=r.device) + 0.5) / (p * s)
    ys = y1[..., None] + bh[..., None] * frac  # [B, N, P*s]
    xs = x1[..., None] + bw[..., None] * frac
    yi = torch.floor(ys).clamp(0, h - 1).to(torch.int64)
    xi = torch.floor(xs).clamp(0, w - 1).to(torch.int64)
    idx = yi[..., :, None] * w + xi[..., None, :]  # [B, N, P*s, P*s]
    rows = torch.arange(b, device=features.device)[:, None, None, None]
    vals = features.reshape(b, h * w, c)[rows, idx]  # [B, N, P*s, P*s, C]
    return vals.reshape(b, n, p, s, p, s, c).amax(dim=(3, 5))
