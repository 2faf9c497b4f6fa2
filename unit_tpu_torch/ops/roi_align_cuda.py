"""Wrapper of the ROIAlignV2 forward kernel (``csrc/roi_align_fwd.cu``).

Counterpart of unit_tpu/ops/roi_align_pallas.py::roi_align_pallas_batched
(forward only).  The plain PyTorch version of the same function is
``unit_tpu_torch.ops.roi_align.roi_align_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library("roi_align_fwd")
    fn = lib.roi_align_fwd_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
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
    if features.requires_grad:
        raise NotImplementedError(
            "ROIAlign backward (K2, unit_tpu/ops/roi_align_pallas_bwd.py) is not "
            "ported yet (ROADMAP Queue 2); run the forward under torch.no_grad()"
        )
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
