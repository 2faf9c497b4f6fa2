"""ROIAlignV2 ("aligned") on [B, H, W, C] feature maps, and its gradient.

Port of unit_tpu/ops/roi_align.py:29-195 and of the custom_vjp of
unit_tpu/ops/roi_align_pallas.py:221-314.  ``roi_align_batched`` dispatches
between the hand-written CUDA kernels (``roi_align_cuda``, K1, and
``roi_align_backward_cuda``, K2) and their plain PyTorch versions
``roi_align_plain`` (a vectorised gather in f32) and
``roi_align_backward_plain`` (an explicit f32 scatter).  The kernels sum in a
separable form; ``roi_align_separable`` and ``roi_align_backward_separable``
form exactly those sums in PyTorch (dense, for tests and small shapes):

    impl="auto"   kernels for CUDA tensors, plain versions for CPU tensors
    impl="cuda"   kernels; raises for CPU tensors
    impl="plain"  plain versions (tests and chip_smoke.py's comparisons)

When the features require grad, the call goes through
``RoIAlignV2Function``, whose forward is K1 (or roi_align_plain) and whose
backward is K2 (or roi_align_backward_plain); the ROIs get no gradient.

Semantics (all four): ROI corners scaled by ``spatial_scale`` and shifted by
-0.5; each of the P x P bins averages s x s bilinear samples; a sample
outside [-1, H] x [-1, W] contributes zero.  The sampling ratio is fixed, not
adaptive (docs/DEVIATIONS.md).  The pooled output and the feature gradient
keep the feature dtype; sums are f32.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .roi_align_cuda import roi_align_backward_cuda, roi_align_cuda


def _corners(v: torch.Tensor, size: int):
    """Bilinear corners of coordinates ``v`` along an axis of length ``size``:
    (lo, hi) int64 indices, (1 - l, l) weights and the outside mask.  A NaN
    coordinate (a diverged step's ROI) samples index 0, as the kernels'
    fmaxf/fminf clamp does."""
    oob = (v < -1.0) | (v > size)
    vc = torch.where(torch.isnan(v), 0.0, v).clamp(0.0, size - 1)
    v0 = torch.floor(vc)
    hi = (v0 + 1).clamp_max(size - 1)
    l = vc - v0
    return v0.to(torch.int64), hi.to(torch.int64), 1.0 - l, l, oob


def _bilinear_gather(flat: torch.Tensor, h: int, w: int, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Sample ``flat`` [H*W, C] at float coords y, x [...] -> [..., C] f32."""
    y0i, y1i, hy, ly, y_oob = _corners(y, h)
    x0i, x1i, hx, lx, x_oob = _corners(x, w)
    oob = y_oob | x_oob

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
                       sampling_ratio: int, aligned: bool = True):
    """Sample coordinates per ROI: ([N, P*s] ys, [N, P*s] xs).  Unaligned
    (the legacy ROIAlign): no -0.5 shift, and each ROI at least one feature
    pixel wide and high (unit_tpu/ops/roi_align.py:66-80)."""
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - offset
    y1 = rois[:, 1] * spatial_scale - offset
    x2 = rois[:, 2] * spatial_scale - offset
    y2 = rois[:, 3] * spatial_scale - offset
    if not aligned:
        x2 = torch.maximum(x2, x1 + 1.0)
        y2 = torch.maximum(y2, y1 + 1.0)
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
    aligned: bool = True,
) -> torch.Tensor:
    """Plain PyTorch ROIAlign: [B, H, W, C], [B, N, 4] -> [B, N, P, P, C],
    interpolated and averaged in f32, returned in the feature dtype.  ROIs go
    through in chunks to bound the [chunk, P*s, P*s, C] gather.  ``aligned``
    False: the legacy ROIAlign of POOLER_TYPE "ROIAlign" (no kernel)."""
    b, h, w, c = features.shape
    n = rois.shape[1]
    p, s = output_size, sampling_ratio
    out = torch.empty((b, n, p, p, c), dtype=features.dtype, device=features.device)
    for i in range(b):
        flat = features[i].reshape(h * w, c)
        for lo in range(0, n, chunk_size):
            chunk = rois[i, lo:lo + chunk_size].to(torch.float32)
            ys, xs = _roi_sample_coords(chunk, p, spatial_scale, s, aligned)
            yy = ys[:, :, None].expand(-1, -1, xs.shape[1])
            xx = xs[:, None, :].expand(-1, ys.shape[1], -1)
            vals = _bilinear_gather(flat, h, w, yy, xx)  # [n_c, P*s, P*s, C]
            vals = vals.reshape(-1, p, s, p, s, c).mean(dim=(2, 4))
            out[i, lo:lo + chunk.shape[0]] = vals.to(features.dtype)
    return out


def roi_align_backward_plain(
    g: torch.Tensor,
    rois: torch.Tensor,
    feature_shape,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    chunk_size: int = 64,
    aligned: bool = True,
) -> torch.Tensor:
    """Plain PyTorch gradient of ROIAlignV2 w.r.t. the features: g
    [B, N, P, P, C], rois [B, N, 4], feature_shape (B, H, W, C) -> dF
    [B, H, W, C] in the dtype of g.  Each sample's g / s^2 times each
    corner's bilinear weight is scattered with ``index_add_`` into an f32
    buffer, ROIs in chunks (no autograd through the forward).  ``aligned``
    False: the legacy ROIAlign's gradient."""
    b, h, w, c = (int(v) for v in feature_shape)
    n = rois.shape[1]
    p, s = output_size, sampling_ratio
    out = torch.zeros((b, h * w, c), dtype=torch.float32, device=g.device)
    inv = 1.0 / (s * s)
    for i in range(b):
        for lo in range(0, n, chunk_size):
            chunk = rois[i, lo:lo + chunk_size].to(torch.float32)
            m = chunk.shape[0]
            ys, xs = _roi_sample_coords(chunk, p, spatial_scale, s, aligned)
            y_lo, y_hi, y_wl, y_wh, y_oob = _corners(ys, h)
            x_lo, x_hi, x_wl, x_wh, x_oob = _corners(xs, w)
            inside = ~(y_oob[:, :, None] | x_oob[:, None, :])  # [m, P*s, P*s]
            gs = g[i, lo:lo + m].to(torch.float32) * inv     # [m, P, P, C]
            gs = gs[:, :, None, :, None, :].expand(m, p, s, p, s, c).reshape(
                m, p * s, p * s, c)
            for yi, wy in ((y_lo, y_wl), (y_hi, y_wh)):
                for xi, wx in ((x_lo, x_wl), (x_hi, x_wh)):
                    wgt = torch.where(inside, wy[:, :, None] * wx[:, None, :], 0.0)
                    idx = yi[:, :, None] * w + xi[:, None, :]
                    out[i].index_add_(0, idx.reshape(-1), (gs * wgt[..., None]).reshape(-1, c))
    return out.reshape(b, h, w, c).to(g.dtype)


def roi_axis_weights(pos: torch.Tensor, size: int, sampling_ratio: int) -> torch.Tensor:
    """Dense bilinear weights of each ROI's bins along one axis of length
    ``size``, from the sample coordinates ``pos`` [N, P*s] of that axis:
    [N, P, size] f32.  Entry [n, p, i] is the sum, over the s samples of bin
    p, of the sample's weight on index i (1 - l on its low corner plus l on
    its high corner; both on the same index where the clamp makes them equal;
    nothing for a sample outside [-1, size]), times 1/s."""
    n, s = pos.shape[0], sampling_ratio
    lo, hi, wl, wh, oob = _corners(pos, size)
    inside = (~oob).to(torch.float32) / s
    dense = torch.zeros((n, pos.shape[1], size), dtype=torch.float32, device=pos.device)
    dense.scatter_add_(2, lo[..., None], (wl * inside)[..., None])
    dense.scatter_add_(2, hi[..., None], (wh * inside)[..., None])
    return dense.reshape(n, -1, s, size).sum(2)


def roi_align_separable(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    chunk_size: int = 64,
) -> torch.Tensor:
    """ROIAlignV2 in its separable form, the sums K1 forms: a sample's weight
    on a cell is a y-factor times an x-factor, and a sample outside on either
    axis has weight 0 on that axis, so per ROI

        out[ph, pw, c] = sum_x Wx[pw, x] * (sum_y Wy[ph, y] * F[y, x, c])

    with Wy [N, P, H] and Wx [N, P, W] from ``roi_axis_weights`` (1/s folded
    into each axis).  Same arguments and result as ``roi_align_plain``, f32
    up to the one rounding to the feature dtype; dense, for tests and small
    shapes only."""
    b, h, w, c = features.shape
    n = rois.shape[1]
    p, s = output_size, sampling_ratio
    out = torch.empty((b, n, p, p, c), dtype=features.dtype, device=features.device)
    for i in range(b):
        f32 = features[i].to(torch.float32)
        for lo in range(0, n, chunk_size):
            chunk = rois[i, lo:lo + chunk_size].to(torch.float32)
            ys, xs = _roi_sample_coords(chunk, p, spatial_scale, s)
            wy = roi_axis_weights(ys, h, s)
            wx = roi_axis_weights(xs, w, s)
            t = torch.einsum("nph,hwc->npwc", wy, f32)
            out[i, lo:lo + chunk.shape[0]] = torch.einsum("nqw,npwc->npqc", wx, t).to(
                features.dtype)
    return out


def roi_align_backward_separable(
    g: torch.Tensor,
    rois: torch.Tensor,
    feature_shape,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    chunk_size: int = 64,
) -> torch.Tensor:
    """The gradient of ROIAlignV2 in its separable form, the sums K2 forms:
    a sample's weight on a cell is a y-factor times an x-factor, and a sample
    outside on either axis has weight 0 on that axis, so per ROI

        dF[y, x, c] = sum_pw Wx[pw, x] * (sum_ph Wy[ph, y] * g[ph, pw, c])

    with Wy [N, P, H] and Wx [N, P, W] from ``roi_axis_weights``.  Same
    arguments and result as ``roi_align_backward_plain``; dense, for tests
    and small shapes only."""
    b, h, w, c = (int(v) for v in feature_shape)
    n = rois.shape[1]
    p, s = output_size, sampling_ratio
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device)
    for i in range(b):
        for lo in range(0, n, chunk_size):
            chunk = rois[i, lo:lo + chunk_size].to(torch.float32)
            ys, xs = _roi_sample_coords(chunk, p, spatial_scale, s)
            wy = roi_axis_weights(ys, h, s)
            wx = roi_axis_weights(xs, w, s)
            t = torch.einsum("nph,npqc->nhqc", wy, g[i, lo:lo + chunk_size].to(torch.float32))
            out[i] += torch.einsum("nqw,nhqc->hwc", wx, t)
    return out.to(g.dtype)


def roi_row_support(rois: torch.Tensor, h: int, w: int, output_size: int = 14,
                    spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """The feature rows a ROI's gradient can touch, for ROIs [N, 4]: (first,
    last) int64 [N], inclusive, first > last for a ROI that touches none.
    The rows run from the low corner of the first y-sample to the high corner
    of the last (the samples are monotone along a side); a ROI whose samples
    all lie beyond the same border of the map, on either axis, has no
    support.  It may hold rows on which every weight is 0 (a superset), never
    fewer."""
    ys, xs = _roi_sample_coords(rois.to(torch.float32), output_size, spatial_scale,
                                sampling_ratio)

    def beyond(pos, size):  # the first and the last sample past the same border
        a, z = pos[:, 0], pos[:, -1]
        return ((a > size) & (z > size)) | ((a < -1.0) & (z < -1.0))

    lo, hi, _, _, _ = _corners(ys[:, [0, -1]], h)
    empty = beyond(ys, h) | beyond(xs, w)
    return (torch.where(empty, 1, lo.min(1).values), torch.where(empty, 0, hi.max(1).values))


def roi_row_lists(rois: torch.Tensor, h: int, w: int, output_size: int = 14,
                  spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """Plain version of K2's list kernel: for ROIs [B, N, 4], the indices of
    the ROIs whose row support holds row y, in ROI order: (lists [B, H, N]
    int32, filled from the front and padded with -1, lengths [B, H] int32)."""
    b, n = rois.shape[:2]
    lists = torch.full((b, h, n), -1, dtype=torch.int32, device=rois.device)
    rows = torch.arange(h, device=rois.device)[:, None]
    index = torch.arange(n, dtype=torch.int32, device=rois.device).expand(h, n)
    for i in range(b):
        lo, hi = roi_row_support(rois[i], h, w, output_size, spatial_scale, sampling_ratio)
        hit = (lo[None, :] <= rows) & (rows <= hi[None, :])  # [H, N]
        # a stable sort of the misses behind the hits keeps the ROI order
        order = torch.sort((~hit).to(torch.int8), dim=1, stable=True).indices
        lists[i] = torch.where(torch.gather(hit, 1, order), torch.gather(index, 1, order), -1)
    return lists, (lists >= 0).sum(2).to(torch.int32)


class RoIAlignV2Function(torch.autograd.Function):
    """ROIAlignV2 with its gradient: forward K1 and backward K2 for
    impl="cuda", roi_align_plain and roi_align_backward_plain for
    impl="plain".  The ROIs get no gradient (unit_tpu returns zeros).

    With impl="cuda" the backward takes ``output_size`` <= 32
    (``roi_align_cuda.MAX_BWD_OUTPUT_SIZE``: K2 keeps one bin a lane) and
    raises above it, naming the limit; the forward kernel and the plain
    versions take any size.  Every shipped recipe pools at 6, 14 or 17.
    ``aligned`` False (the legacy ROIAlign) takes impl="plain" only."""

    @staticmethod
    def forward(ctx, features, rois, output_size, spatial_scale, sampling_ratio, impl,
                aligned=True):
        ctx.save_for_backward(rois)
        ctx.args = (tuple(features.shape), output_size, spatial_scale, sampling_ratio, impl,
                    aligned)
        if impl == "cuda":
            return roi_align_cuda(features, rois, output_size, spatial_scale, sampling_ratio)
        return roi_align_plain(features, rois, output_size, spatial_scale, sampling_ratio,
                               aligned=aligned)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (rois,) = ctx.saved_tensors
        shape, output_size, spatial_scale, sampling_ratio, impl, aligned = ctx.args
        if impl == "cuda":
            df = roi_align_backward_cuda(g.contiguous(), rois, shape, output_size,
                                         spatial_scale, sampling_ratio)
        else:
            df = roi_align_backward_plain(g.contiguous(), rois, shape, output_size,
                                          spatial_scale, sampling_ratio, aligned=aligned)
        return df, None, None, None, None, None, None


def roi_align_batched(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
    impl: str = "auto",
    aligned: bool = True,
) -> torch.Tensor:
    """Whole-batch ROIAlignV2 -> [B, N, P, P, C] (see the module docstring).
    Without a gradient, "auto" and "cuda" on a CUDA tensor go through the
    registered operator ``library.roi_align`` (K1 on the card, the plain
    version on the CPU), which ``torch.export`` can trace.

    ``aligned`` False is the legacy ROIAlign (POOLER_TYPE "ROIAlign"), which
    unit_tpu computes in XLA, never in its kernel: here the plain versions,
    forward and backward, whatever ``impl`` says."""
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown ROIAlign impl {impl!r} (auto | cuda | plain)")
    if not aligned:
        if features.requires_grad and torch.is_grad_enabled():
            return RoIAlignV2Function.apply(features, rois, output_size, spatial_scale,
                                            sampling_ratio, "plain", False)
        return roi_align_plain(features, rois, output_size, spatial_scale, sampling_ratio,
                               aligned=False)
    if features.requires_grad and torch.is_grad_enabled():
        if impl == "auto":
            impl = "cuda" if features.is_cuda else "plain"
        return RoIAlignV2Function.apply(features, rois, output_size, spatial_scale,
                                        sampling_ratio, impl)
    if impl == "plain":
        return roi_align_plain(features, rois, output_size, spatial_scale, sampling_ratio)
    if impl == "cuda" and not features.is_cuda:
        return roi_align_cuda(features, rois, output_size, spatial_scale, sampling_ratio)
    return library.roi_align(features, rois, output_size, spatial_scale, sampling_ratio)


# the registered operators call back into this module (a cycle: imported last)
from . import library  # noqa: E402
