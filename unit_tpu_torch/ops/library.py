"""K1, K3 and K4 as registered PyTorch operators, for ``torch.export``.

An exported program (``serving/export.py``) cannot hold a ctypes call, nor
the plain NMS, whose greedy walk reads the device (``int(alive.sum())``,
``.tolist()``) and ends early.  So the three kernels of the served path are
custom operators under the ``unit_tpu_torch::`` namespace, each with a fake
(shape-only) implementation that tracing runs instead:

    roi_align    K1: features [B, H, W, C] x rois [B, N, 4] f32
                 -> [B, N, P, P, C] in the features' dtype
    nms_keep     K3: score-sorted boxes [B, N, 4] f32, n_valid [B] int32 or
                 None -> keep mask [B, N] bool
    bn_act       K4 forward: an output with the shape, dtype and strides of x

On a CUDA tensor an operator calls the kernel's wrapper, looked up in the
dispatching module at each call (``ops.roi_align.roi_align_cuda``,
``ops.nms.nms_sorted_mask_cuda``, ``ops.bn_act.bn_act_forward_cuda``), so the
wrapper's launch count also counts the launches of an exported program; on a
CPU tensor it calls the plain version.  The dispatchers
(``roi_align_batched``, ``nms_sorted_mask``, ``bn_act``) call these operators
wherever no gradient is taken; training keeps its autograd Functions, which
call the wrappers themselves.  unit_tpu needs nothing of the kind: its Pallas
kernels lower to custom calls that ``jax.export`` lets through
(unit_tpu/serving/export.py:40-50).

Importing this module registers the operators once per process;
``serving.export.load_exported`` imports it before it loads a program.
"""

from __future__ import annotations

import torch

from . import bn_act as _bn_act
from .bn_act_cuda import nhwc_dense
from . import nms as _nms
from . import roi_align as _roi_align


@torch.library.custom_op("unit_tpu_torch::roi_align", mutates_args=(), device_types="cpu")
def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int) -> torch.Tensor:
    """ROIAlignV2 forward (K1 on the card, ``roi_align_plain`` on the CPU)."""
    return _roi_align.roi_align_plain(features, rois, output_size, spatial_scale,
                                      sampling_ratio)


@roi_align.register_kernel("cuda")
def _(features, rois, output_size, spatial_scale, sampling_ratio):
    return _roi_align.roi_align_cuda(features, rois, output_size, spatial_scale,
                                     sampling_ratio)


@roi_align.register_fake
def _(features, rois, output_size, spatial_scale, sampling_ratio):
    b, _, _, c = features.shape
    return features.new_empty((b, rois.shape[1], output_size, output_size, c))


@torch.library.custom_op("unit_tpu_torch::nms_keep", mutates_args=(), device_types="cpu")
def nms_keep(sorted_boxes: torch.Tensor, n_valid: torch.Tensor | None, iou_threshold: float,
             max_keep: int) -> torch.Tensor:
    """Greedy-NMS keep mask of each image of score-sorted boxes (K3 on the
    card, ``nms_sorted_mask_plain`` on the CPU, which needs no ``n_valid``:
    rows at or after it are all-zero boxes, never kept).  Without
    ``n_valid`` the kernel walks every row."""
    return _nms.nms_sorted_mask_plain(sorted_boxes, iou_threshold, max_keep)


@nms_keep.register_kernel("cuda")
def _(sorted_boxes, n_valid, iou_threshold, max_keep):
    return _nms.nms_sorted_mask_cuda(sorted_boxes, iou_threshold, max_keep, n_valid=n_valid)


@nms_keep.register_fake
def _(sorted_boxes, n_valid, iou_threshold, max_keep):
    return sorted_boxes.new_empty(sorted_boxes.shape[:-1], dtype=torch.bool)


def _like_x(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` (the epilogue's values, freshly allocated and dense) with the
    strides ``torch.empty_like(x)`` gives, as the fake implementation
    promises.  A dense x keeps its strides under ``empty_like``: where they
    are out's, or differ only in the strides of size-1 dimensions (K4 writes
    NHWC-dense memory for an NHWC-dense x), ``out`` serves as it is or as a
    view; any other x costs a copy."""
    if out.stride() == x.stride():
        return out
    if nhwc_dense(x) and nhwc_dense(out):
        return out.as_strided(x.shape, x.stride())
    return torch.empty_like(x).copy_(out)


@torch.library.custom_op("unit_tpu_torch::bn_act", mutates_args=(), device_types="cpu")
def bn_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
           residual: torch.Tensor | None, relu: bool) -> torch.Tensor:
    """The FrozenBN + residual + ReLU epilogue forward (K4 on the card,
    ``bn_act_plain`` on the CPU)."""
    return _like_x(x, _bn_act.bn_act_plain(x, scale, shift, residual, relu))


@bn_act.register_kernel("cuda")
def _(x, scale, shift, residual, relu):
    return _like_x(x, _bn_act.bn_act_forward_cuda(x, scale, shift, residual, relu))


@bn_act.register_fake
def _(x, scale, shift, residual, relu):
    return torch.empty_like(x)
