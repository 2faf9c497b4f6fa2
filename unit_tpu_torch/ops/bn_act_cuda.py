"""Wrappers of the fused FrozenBN + residual + ReLU kernel K4
(``csrc/bn_act.cu``), forward and backward.

Counterpart of ``ep_pallas`` in scripts/bench_backbone_epilogue.py:155.  The
plain PyTorch version is ``ops.bn_act.bn_act_plain``; ``ops.bn_act.bn_act``
pairs the two launches for autograd.

Activations are NCHW tensors whose memory is NHWC-dense (``channels_last``);
the kernel reads that memory as rows of C channels.  ``is_contiguous(
memory_format=torch.channels_last)`` cannot be trusted for N = 1, C = 1 or
H = W = 1, so :func:`nhwc_dense` compares the strides themselves.  A tensor
with other strides is copied into NHWC-dense memory first, and the copy is
counted in ``layout_copies``: the kernel never reads through wrong strides.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# copies made because an operand was not NHWC-dense (a convolution that hands
# back another layout costs one such copy per call)
layout_copies = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_lib.load_library("bn_act")
    p, i = ctypes.c_void_p, ctypes.c_int
    # (x, res, scale, shift, out, rows, c, relu, dtype, stream)
    lib.bn_act_fwd_launch.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i, p]
    lib.bn_act_fwd_launch.restype = i
    # (g, y, scale, dx, dres, rows, c, relu, dtype, stream)
    lib.bn_act_bwd_launch.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i, p]
    lib.bn_act_bwd_launch.restype = i
    return lib


def nhwc_strides(shape) -> Tuple[int, int, int, int]:
    """Strides of an NCHW-shaped tensor whose memory is [N, H, W, C] row-major."""
    _, c, h, w = shape
    return (h * w * c, 1, w * c, c)


def nhwc_dense(t: torch.Tensor) -> bool:
    """True if ``t`` [N, C, H, W] addresses its elements as [N, H, W, C]
    row-major memory (the stride of a dimension of size 1 addresses nothing)."""
    return all(size == 1 or stride == want
               for size, stride, want in zip(t.shape, t.stride(), nhwc_strides(t.shape)))


def _dense(t: torch.Tensor) -> torch.Tensor:
    global layout_copies
    if nhwc_dense(t):
        return t
    layout_copies += 1
    return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _empty_like_nhwc(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(tuple(t.shape), nhwc_strides(t.shape), dtype=t.dtype,
                               device=t.device)


def _check(x: torch.Tensor, scale: torch.Tensor, others) -> None:
    if not x.is_cuda:
        raise ValueError("the bn_act kernel needs CUDA tensors; the plain version is "
                         "ops.bn_act.bn_act_plain")
    if x.dim() != 4:
        raise ValueError(f"need an NCHW tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"activations must be float32 or bfloat16, got {x.dtype}")
    for name, t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} does not match "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    c = x.shape[1]
    if scale.shape != (c,) or scale.dtype != torch.float32 or scale.device != x.device \
            or not scale.is_contiguous():
        raise ValueError(f"scale and shift must be contiguous float32 [{c}] on {x.device}")


def bn_act_forward_cuda(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = True) -> torch.Tensor:
    """act(float(x) * scale + shift [+ float(residual)]) rounded once to x's
    dtype, on the card.  x, residual [N, C, H, W] f32 or bf16; scale, shift
    f32 [C].  Returns an NHWC-dense (channels_last) NCHW tensor."""
    others = [("residual", residual)] if residual is not None else []
    _check(x, scale, others)
    _check(x, shift, [])
    x = _dense(x)
    res = None if residual is None else _dense(residual)
    out = _empty_like_nhwc(x)
    if x.numel() == 0:
        return out
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        rc = _lib().bn_act_fwd_launch(
            x.data_ptr(), None if res is None else res.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), n * h * w, c, int(bool(relu)),
            _DTYPES[x.dtype], cuda_lib.stream_handle(x),
        )
    cuda_lib.check(rc, "bn_act_fwd_launch")
    bn_act_forward_cuda.launches += 1
    return out


bn_act_forward_cuda.launches = 0


def bn_act_backward_cuda(g: torch.Tensor, y: Optional[torch.Tensor], scale: torch.Tensor,
                         relu: bool = True, need_dx: bool = True, need_dres: bool = False
                         ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dres) = (g * (y > 0) * scale, g * (y > 0)) in one pass, each in
    g's dtype, or None where it is not needed; without relu the mask is all
    ones and y is not read (it may be None).  g, y [N, C, H, W]; scale f32 [C]."""
    _check(g, scale, [("y", y)] if relu else [])
    if not (need_dx or need_dres):
        return None, None
    g = _dense(g)
    if not relu and not need_dx:
        return None, g  # dres = g: nothing to compute
    y = _dense(y) if relu else None
    dx = _empty_like_nhwc(g) if need_dx else None
    dres = (_empty_like_nhwc(g) if relu else g) if need_dres else None
    if g.numel() == 0:
        return dx, dres
    n, c, h, w = g.shape
    with torch.cuda.device(g.device):
        rc = _lib().bn_act_bwd_launch(
            g.data_ptr(), None if y is None else y.data_ptr(), scale.data_ptr(),
            None if dx is None else dx.data_ptr(),
            dres.data_ptr() if (dres is not None and relu) else None,
            n * h * w, c, int(bool(relu)), _DTYPES[g.dtype], cuda_lib.stream_handle(g),
        )
    cuda_lib.check(rc, "bn_act_bwd_launch")
    bn_act_backward_cuda.launches += 1
    return dx, dres


bn_act_backward_cuda.launches = 0
