"""Wrapper of the greedy-NMS keep-mask kernel (``csrc/nms_mask.cu``).

Counterpart of unit_tpu/ops/nms_pallas.py::nms_sorted_mask_pallas.  The
plain PyTorch version of the same function is
``unit_tpu_torch.ops.nms.nms_sorted_mask_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import cuda_lib

_SMEM_LIMIT = 48 * 1024  # default dynamic shared memory of one block


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library("nms_mask")
    fn = lib.nms_mask_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def nms_sorted_mask_cuda(
    sorted_boxes: torch.Tensor, iou_threshold: float, max_keep: Optional[int] = None
) -> torch.Tensor:
    """Keep mask [N] bool over boxes [N, 4] f32 sorted by score, on the card.

    The first ``max_keep`` keeps are those of full greedy NMS; later rows come
    back False.  Raises for anything but a contiguous f32 [N, 4] CUDA tensor.
    """
    if not sorted_boxes.is_cuda:
        raise ValueError("nms_sorted_mask_cuda needs a CUDA tensor; the plain "
                         "version is ops.nms.nms_sorted_mask_plain")
    if sorted_boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {sorted_boxes.dtype}")
    if sorted_boxes.dim() != 2 or sorted_boxes.shape[1] != 4:
        raise ValueError(f"boxes must be [N, 4], got {tuple(sorted_boxes.shape)}")
    if not sorted_boxes.is_contiguous():
        raise ValueError("boxes must be contiguous")
    n = sorted_boxes.shape[0]
    keep = torch.empty((n,), dtype=torch.bool, device=sorted_boxes.device)
    if n == 0:
        return keep
    col_blocks = (n + 63) // 64
    if col_blocks * 8 > _SMEM_LIMIT:  # the walk keeps one bit per box in shared memory
        raise ValueError(f"{n} boxes exceed the kernel's shared-memory walk")
    mask = torch.empty((n, col_blocks), dtype=torch.int64, device=sorted_boxes.device)
    cap = n if max_keep is None else max(0, min(int(max_keep), n))
    with torch.cuda.device(sorted_boxes.device):
        rc = _lib().nms_mask_launch(
            sorted_boxes.data_ptr(), n, float(iou_threshold), cap,
            mask.data_ptr(), keep.data_ptr(), cuda_lib.stream_handle(sorted_boxes),
        )
    cuda_lib.check(rc, "nms_mask_launch")
    nms_sorted_mask_cuda.launches += 1
    return keep


nms_sorted_mask_cuda.launches = 0
