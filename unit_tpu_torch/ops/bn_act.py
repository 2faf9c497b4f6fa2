"""Fused FrozenBN + residual + ReLU epilogue of a convolution.

    out = act(float(x) * scale + shift [+ float(residual)])    cast to x.dtype

computed in f32 and rounded once, as ``ep_kernel`` of
scripts/bench_backbone_epilogue.py:145 does on the TPU (unit_tpu's FrozenBN
module itself rounds scale, shift and every intermediate to the compute dtype:
about one bf16 ulp per epilogue apart, nothing apart in f32).  x and residual
are NCHW tensors, scale and shift f32 [C] from ``FrozenBN.scale_shift``.

``impl``: "cuda" launches the hand-written kernel K4 (``csrc/bn_act.cu``)
forward and, through autograd, backward; "plain" is the same f32 expression
in PyTorch ops, differentiated by autograd; "auto" takes the kernel for a CUDA
tensor and the plain version for a CPU tensor.  A CUDA tensor never falls
back: a kernel that does not build or launch raises.

scale and shift get no gradient: FrozenBN's tensors are buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .bn_act_cuda import bn_act_backward_cuda, bn_act_forward_cuda


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 residual: Optional[torch.Tensor] = None, relu: bool = True) -> torch.Tensor:
    """The epilogue in plain PyTorch ops: ((x * scale) + shift) [+ residual],
    each op rounded to f32, then the ReLU, then one cast to x's dtype."""
    shape = (1, -1, 1, 1)
    y = x.float() * scale.view(shape) + shift.view(shape)
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def bn_act_backward_plain(g: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                          relu: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward formula the kernel implements, in plain PyTorch ops:
    (dx, dres) = (g * (y > 0) * scale, g * (y > 0)) from the saved output y;
    without relu the mask is all ones."""
    gm = g.float()
    if relu:
        gm = gm * (y > 0)
    return (gm * scale.view(1, -1, 1, 1)).to(g.dtype), gm.to(g.dtype)


class _BnActCuda(torch.autograd.Function):
    """K4 forward with K4 backward."""

    @staticmethod
    def forward(ctx, x, scale, shift, residual, relu):
        out = bn_act_forward_cuda(x, scale, shift, residual, relu)
        ctx.relu = relu
        if relu:
            ctx.save_for_backward(out, scale)
        else:
            ctx.save_for_backward(scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        y, scale = (saved[0] if ctx.relu else None), saved[-1]
        dx, dres = bn_act_backward_cuda(g, y, scale, ctx.relu,
                                        need_dx=ctx.needs_input_grad[0],
                                        need_dres=ctx.needs_input_grad[3])
        return dx, None, None, dres, None


def bn_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
           residual: Optional[torch.Tensor] = None, relu: bool = True,
           impl: str = "auto") -> torch.Tensor:
    """The epilogue on NCHW tensors (see the module docstring).  Without a
    gradient, "auto" and "cuda" on a CUDA tensor go through the registered
    operator ``library.bn_act`` (K4's forward on the card, the plain version
    on the CPU), which ``torch.export`` can trace."""
    if impl not in ("auto", "cuda", "plain"):
        raise ValueError(f"unknown bn_act impl {impl!r} (auto | cuda | plain)")
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or (residual is not None and residual.requires_grad))
    if impl == "plain" or (impl == "auto" and needs_grad and not x.is_cuda):
        return bn_act_plain(x, scale, shift, residual, relu)
    if needs_grad or not x.is_cuda and impl == "cuda":
        return _BnActCuda.apply(x, scale, shift, residual, relu)
    return library.bn_act(x, scale, shift, residual, relu)


# the registered operator calls back into this module (a cycle: imported last)
from . import library  # noqa: E402
