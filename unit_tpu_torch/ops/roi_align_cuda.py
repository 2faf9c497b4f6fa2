"""Wrappers of the ROIAlignV2 kernels: forward K1 (``csrc/roi_align_fwd.cu``)
and backward K2 (``csrc/roi_align_bwd.cu``).

Counterparts of unit_tpu/ops/roi_align_pallas.py::roi_align_pallas_batched
and unit_tpu/ops/roi_align_pallas_bwd.py::roi_align_backward_pallas_batched.
Their plain PyTorch versions are ``ops.roi_align.roi_align_plain`` and
``ops.roi_align.roi_align_backward_plain``; ``ops.roi_align.RoIAlignV2Function``
pairs them for autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# (data, dtype, rois, out, [scratch,] b, n, h, w, c, p, s, scale, stream)
_SIZES = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + _SIZES
# K2's warps keep their rows' f32 sums in the shared memory of their block: at
# most 227 KB on sm_90.
_BWD_SMEM_LIMIT = 232448
# How K2 cuts its work (chosen on the H100 at the flagship's shapes; PERF.md):
# "seg" entries of a feature row's list per warp at most (a row with more is
# summed through the f32 scratch), "warps" slices of 64 channels per block.
BWD_TUNING = {"seg": 64, "warps": 4}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library("roi_align_fwd")
    lib.roi_align_fwd_launch.argtypes = _ARGTYPES
    lib.roi_align_fwd_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library("roi_align_bwd")
    # (g, dtype, rois, out, scratch, work, b, n, h, w, c, p, s, scale, seg, warps, stream)
    lib.roi_align_bwd_launch.argtypes = (
        _ARGTYPES[:4] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.roi_align_bwd_launch.restype = ctypes.c_int
    # (rois, lists, lens, b, n, h, w, p, s, scale, stream)
    lib.roi_align_bwd_lists_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    lib.roi_align_bwd_lists_launch.restype = ctypes.c_int
    lib.roi_align_bwd_work_bytes.argtypes = [ctypes.c_int] * 5
    lib.roi_align_bwd_work_bytes.restype = ctypes.c_longlong
    return lib


def roi_align_cuda(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """ROIAlignV2 on the card: features [B, H, W, C] (f32 or bf16, contiguous
    channels-last), rois [B, N, 4] f32 -> [B, N, P, P, C] in the feature dtype."""
    if not (features.is_cuda and rois.is_cuda):
        raise ValueError("roi_align_cuda needs CUDA tensors; the plain version "
                         "is ops.roi_align.roi_align_plain")
    if features.device != rois.device:
        raise ValueError(f"features on {features.device}, rois on {rois.device}")
    if features.dtype not in _DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"need [B,H,W,C] and [B,N,4], got {tuple(features.shape)} "
                         f"and {tuple(rois.shape)}")
    b, h, w, c = features.shape
    if rois.shape[0] != b:
        raise ValueError(f"batch {b} of features vs {rois.shape[0]} of rois")
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError("features and rois must be contiguous ([B,H,W,C] row-major)")
    if c % 2 or features.data_ptr() % 4:
        raise ValueError(f"the kernel reads channel pairs: C={c} must be even and "
                         "the feature pointer 4-byte aligned")
    if output_size < 1 or sampling_ratio < 1:
        raise ValueError("output_size and sampling_ratio must be >= 1")
    n = rois.shape[1]
    p = int(output_size)
    out = torch.empty((b, n, p, p, c), dtype=features.dtype, device=features.device)
    if b * n == 0:
        return out
    with torch.cuda.device(features.device):
        rc = _lib().roi_align_fwd_launch(
            features.data_ptr(), _DTYPES[features.dtype], rois.data_ptr(), out.data_ptr(),
            b, n, h, w, c, p, int(sampling_ratio), float(spatial_scale),
            cuda_lib.stream_handle(features),
        )
    cuda_lib.check(rc, "roi_align_fwd_launch")
    roi_align_cuda.launches += 1
    return out


roi_align_cuda.launches = 0


def roi_align_backward_cuda(
    g: torch.Tensor,
    rois: torch.Tensor,
    feature_shape,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Gradient of ROIAlignV2 w.r.t. the features on the card: g [B, N, P, P, C]
    (f32 or bf16, contiguous), rois [B, N, 4] f32, feature_shape (B, H, W, C)
    -> dF [B, H, W, C] in the dtype of g, summed in f32, deterministic.

    Counterpart of unit_tpu's roi_align_backward_pallas_batched.  The scatter
    is bound by its accumulator updates, not by the bytes of g, so the kernel
    sums in the separable form (``ops.roi_align.roi_align_backward_separable``
    is the same sums in PyTorch): per ROI and feature row it first reduces g
    over the bins ph in registers and scatters that row once through merged
    column weights; and it visits, per row, only the ROIs that touch it, in
    ROI order, from per-row lists (``ops.roi_align.roi_row_lists`` is their
    plain version) cut into segments of at most ``BWD_TUNING["seg"]`` entries.
    One call queues four device kernels (tables, lists, rows, sum) on the
    current stream and never waits for the device.

    Allocated here: the workspace (taps [2, B, N, P, 2s] of 8 bytes, lists
    [B, H, N] and lengths [B, H] int32) and, when N exceeds the segment, the
    f32 scratch [ceil(N / seg), B, H, W, C], of which only rows with more
    than one segment are written and read.  Their sizes in bytes are left in
    ``roi_align_backward_cuda.scratch_bytes``."""
    if not (g.is_cuda and rois.is_cuda):
        raise ValueError("roi_align_backward_cuda needs CUDA tensors; the plain "
                         "version is ops.roi_align.roi_align_backward_plain")
    if g.device != rois.device:
        raise ValueError(f"g on {g.device}, rois on {rois.device}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    b, h, w, c = (int(v) for v in feature_shape)
    p, s = int(output_size), int(sampling_ratio)
    if rois.dim() != 3 or rois.shape[0] != b or rois.shape[-1] != 4:
        raise ValueError(f"need rois [{b},N,4], got {tuple(rois.shape)}")
    n = rois.shape[1]
    if tuple(g.shape) != (b, n, p, p, c):
        raise ValueError(f"need g {(b, n, p, p, c)}, got {tuple(g.shape)}")
    if not (g.is_contiguous() and rois.is_contiguous()):
        raise ValueError("g and rois must be contiguous")
    if c % 2 or g.data_ptr() % (2 * g.element_size()):
        raise ValueError(f"the kernel reads channel pairs: C={c} must be even and "
                         "the pointer of g aligned to two elements")
    if p < 1 or s < 1 or h < 1 or w < 1:
        raise ValueError("output_size, sampling_ratio, H and W must be >= 1")
    if p > 32:
        raise ValueError(f"output_size {p}: the kernel keeps one bin per lane (at most 32)")
    seg, warps = int(BWD_TUNING["seg"]), int(BWD_TUNING["warps"])
    smem = (w * 64 + 12 * p * 2 * s) * 4  # one warp's row of sums, three ROIs' taps
    if smem > _BWD_SMEM_LIMIT:
        raise ValueError(f"W={w} needs {smem} B of shared memory for a warp's row "
                         f"of sums (limit {_BWD_SMEM_LIMIT})")
    warps = max(1, min(warps, _BWD_SMEM_LIMIT // smem))
    if b * n == 0:
        return torch.zeros((b, h, w, c), dtype=g.dtype, device=g.device)
    lib = _bwd_lib()
    out = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    work = torch.empty(-(-lib.roi_align_bwd_work_bytes(b, n, h, p, s) // 8), dtype=torch.int64,
                       device=g.device)
    segments = -(-n // seg)
    part = torch.empty((segments if segments > 1 else 0, b, h, w, c), dtype=torch.float32,
                       device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.roi_align_bwd_launch(
            g.data_ptr(), _DTYPES[g.dtype], rois.data_ptr(), out.data_ptr(), part.data_ptr(),
            work.data_ptr(), b, n, h, w, c, p, s, float(spatial_scale), seg, warps,
            cuda_lib.stream_handle(g),
        )
    cuda_lib.check(rc, "roi_align_bwd_launch")
    roi_align_backward_cuda.launches += 1
    roi_align_backward_cuda.scratch_bytes = {
        "scratch": part.numel() * 4, "workspace": work.numel() * 8}
    return out


roi_align_backward_cuda.launches = 0
roi_align_backward_cuda.scratch_bytes = {"scratch": 0, "workspace": 0}


def roi_row_lists_cuda(rois: torch.Tensor, h: int, w: int, output_size: int = 14,
                       spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """K2's list kernel alone, for tests: rois [B, N, 4] f32 on the card ->
    (lists [B, H, N] int32, lengths [B, H] int32) as
    ``ops.roi_align.roi_row_lists`` gives them (ROI order, padded with -1)."""
    if not rois.is_cuda:
        raise ValueError("roi_row_lists_cuda needs a CUDA tensor; the plain "
                         "version is ops.roi_align.roi_row_lists")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"need rois [B,N,4] float32, got {tuple(rois.shape)} {rois.dtype}")
    if not rois.is_contiguous():
        raise ValueError("rois must be contiguous")
    b, n = rois.shape[:2]
    lists = torch.full((b, h, n), -1, dtype=torch.int32, device=rois.device)
    lens = torch.zeros((b, h), dtype=torch.int32, device=rois.device)
    if b * n * h == 0:
        return lists, lens
    with torch.cuda.device(rois.device):
        rc = _bwd_lib().roi_align_bwd_lists_launch(
            rois.data_ptr(), lists.data_ptr(), lens.data_ptr(), b, n, h, w, int(output_size),
            int(sampling_ratio), float(spatial_scale), cuda_lib.stream_handle(rois),
        )
    cuda_lib.check(rc, "roi_align_bwd_lists_launch")
    return lists, lens
