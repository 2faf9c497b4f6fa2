"""ROIAlignV2 ("aligned") on [B, H, W, C] feature maps.

Port of unit_tpu/ops/roi_align.py:29-195.  ``roi_align_batched`` dispatches
between the hand-written CUDA kernel (``roi_align_cuda``, K1, forward only)
and its plain PyTorch version ``roi_align_plain``, a vectorised gather in f32:

    impl="auto"   kernel for CUDA tensors, plain version for CPU tensors
    impl="cuda"   kernel; raises for CPU tensors
    impl="plain"  plain version (tests and chip_smoke.py's comparisons)

Semantics (both): ROI corners scaled by ``spatial_scale`` and shifted by
-0.5; each of the P x P bins averages s x s bilinear samples; a sample
outside [-1, H] x [-1, W] contributes zero.  The sampling ratio is fixed, not
adaptive (docs/DEVIATIONS.md).  The pooled output keeps the feature dtype.
"""

from __future__ import annotations

import torch

from .roi_align_cuda import roi_align_cuda


def _bilinear_gather(flat: torch.Tensor, h: int, w: int, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Sample ``flat`` [H*W, C] at float coords y, x [...] -> [..., C] f32."""
    oob = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    yc = y.clamp(0.0, h - 1)
    xc = x.clamp(0.0, w - 1)
    y0 = torch.floor(yc)
    x0 = torch.floor(xc)
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    ly = yc - y0
    lx = xc - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    y0i, y1i, x0i, x1i = (v.to(torch.int64) for v in (y0, y1, x0, x1))

    def g(yi, xi):
        return flat[yi * w + xi].to(torch.float32)

    val = (
        g(y0i, x0i) * (hy * hx)[..., None]
        + g(y0i, x1i) * (hy * lx)[..., None]
        + g(y1i, x0i) * (ly * hx)[..., None]
        + g(y1i, x1i) * (ly * lx)[..., None]
    )
    return torch.where(oob[..., None], 0.0, val)


def _roi_sample_coords(rois: torch.Tensor, output_size: int, spatial_scale: float,
                       sampling_ratio: int):
    """Sample coordinates per ROI: ([N, P*s] ys, [N, P*s] xs)."""
    x1 = rois[:, 0] * spatial_scale - 0.5
    y1 = rois[:, 1] * spatial_scale - 0.5
    x2 = rois[:, 2] * spatial_scale - 0.5
    y2 = rois[:, 3] * spatial_scale - 0.5
    # True divisions, as in unit_tpu and the kernel: on a CUDA tensor PyTorch
    # multiplies by the reciprocal of a Python-number divisor, which moves a
    # sample coordinate by an ulp and a bilinear weight with it.
    p_div = torch.full((), float(output_size), dtype=rois.dtype, device=rois.device)
    s_div = torch.full((), float(sampling_ratio), dtype=rois.dtype, device=rois.device)
    bin_w = (x2 - x1) / p_div
    bin_h = (y2 - y1) / p_div
    s = sampling_ratio
    frac = (torch.arange(s, dtype=rois.dtype, device=rois.device) + 0.5) / s_div
    bins = torch.arange(output_size, dtype=rois.dtype, device=rois.device)
    grid = bins[:, None] + frac[None, :]  # [P, s]
    ys = y1[:, None, None] + bin_h[:, None, None] * grid[None]
    xs = x1[:, None, None] + bin_w[:, None, None] * grid[None]
    return ys.reshape(rois.shape[0], -1), xs.reshape(rois.shape[0], -1)


def roi_align_plain(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    chunk_size: int = 64,
) -> torch.Tensor:
    """Plain PyTorch ROIAlign: [B, H, W, C], [B, N, 4] -> [B, N, P, P, C],
    interpolated and averaged in f32, returned in the feature dtype.  ROIs go
    through in chunks to bound the [chunk, P*s, P*s, C] gather."""
    b, h, w, c = features.shape
    n = rois.shape[1]
    p, s = output_size, sampling_ratio
    out = torch.empty((b, n, p, p, c), dtype=features.dtype, device=features.device)
    for i in range(b):
        flat = features[i].reshape(h * w, c)
        for lo in range(0, n, chunk_size):
            chunk = rois[i, lo:lo + chunk_size].to(torch.float32)
            ys, xs = _roi_sample_coords(chunk, p, spatial_scale, s)
            yy = ys[:, :, None].expand(-1, -1, xs.shape[1])
            xx = xs[:, None, :].expand(-1, ys.shape[1], -1)
            vals = _bilinear_gather(flat, h, w, yy, xx)  # [n_c, P*s, P*s, C]
            vals = vals.reshape(-1, p, s, p, s, c).mean(dim=(2, 4))
            out[i, lo:lo + chunk.shape[0]] = vals.to(features.dtype)
    return out


def roi_align_batched(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    impl: str = "auto",
) -> torch.Tensor:
    """Whole-batch ROIAlignV2 -> [B, N, P, P, C] (see the module docstring)."""
    if impl == "auto":
        impl = "cuda" if features.is_cuda else "plain"
    if impl == "cuda":
        return roi_align_cuda(features, rois, output_size, spatial_scale, sampling_ratio)
    if impl == "plain":
        return roi_align_plain(features, rois, output_size, spatial_scale, sampling_ratio)
    raise ValueError(f"unknown ROIAlign impl {impl!r} (auto | cuda | plain)")
