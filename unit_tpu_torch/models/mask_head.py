"""The mask head with its base->novel transfer, its loss and its inference.

Port of unit_tpu/models/mask_head.py.  ``MaskRCNNConvUpsampleHead``:
``num_conv`` 3x3 convolutions, a 2x2 stride-2 transposed convolution
(``deconv``) and a 1x1 class-wise ``predictor``; with fine-tuning a
zero-initialised 1x1 ``predictor_delta`` beside it.  Novel-class mask logits
are similarity-weighted combinations of the base-class logits
(``transfer_mask_logits``).  GT masks are carried per instance at a fixed
resolution in the GT box's frame; the loss re-samples each into its
proposal's frame bilinearly (``crop_mask_to_box``), batched over proposals.

Public functions keep the JAX layout ([N, H, W, C] features and logits);
inside, the convolutions run on NCHW tensors in ``channels_last`` memory, in
the compute dtype, and the logits come out in f32.  Initialisers follow
flax's: variance_scaling(2, fan_out, normal) for the convolutions,
normal(0.001) for ``predictor``, zeros for ``predictor_delta``, zero biases.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.comm import global_normalizer
from .predictors import _ids
from .resnet import Conv2d


class Deconv2d(nn.ConvTranspose2d):
    """The 2x2 stride-2 transposed convolution, weight [in, out, 2, 2] (f32)
    run in ``dtype`` on a channels_last map."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 2, stride=2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=self.dtype, memory_format=torch.channels_last)
        return F.conv_transpose2d(x, w, self.bias.to(self.dtype), stride=2)


class MaskRCNNConvUpsampleHead(nn.Module):
    """[N, H, W, in_channels] ROI features -> mask logits [N, 2H, 2W, C] f32,
    and the ``predictor_delta`` logits (or None without ``finetune``)."""

    def __init__(self, in_channels: int, num_classes: int, num_conv: int = 0,
                 conv_dim: int = 256, finetune: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.num_conv = num_conv
        ch = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", Conv2d(
                ch, conv_dim, 3, padding=1, bias=True, dtype=dtype,
                init_std=math.sqrt(2.0 / (9 * conv_dim)), generator=generator))
            ch = conv_dim
        # weight [in, out, 2, 2]: torch's transposed-convolution layout
        self.deconv = Deconv2d(ch, conv_dim, dtype)
        with torch.no_grad():
            self.deconv.weight.normal_(0.0, math.sqrt(2.0 / (4 * conv_dim)), generator=generator)
            self.deconv.bias.zero_()
        self.predictor = Conv2d(conv_dim, num_classes, 1, bias=True, dtype=dtype,
                                init_std=0.001, generator=generator)
        self.predictor_delta = None
        if finetune:
            self.predictor_delta = Conv2d(conv_dim, num_classes, 1, bias=True, dtype=dtype,
                                          init_std=0.0)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(self.num_conv):
            x = torch.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = torch.relu(self.deconv(x))
        logits = self.predictor(x).float().permute(0, 2, 3, 1)
        if self.predictor_delta is None:
            return logits, None
        return logits, self.predictor_delta(x).float().permute(0, 2, 3, 1)


def transfer_mask_logits(
    logits: torch.Tensor,          # [N, H, W, C]
    similarity_seg: torch.Tensor,  # [V, B] or [N, V, B]
    base_ids: Sequence[int],
    novel_ids: Sequence[int],
) -> torch.Tensor:
    """Novel channels replaced by similarity combinations of the base
    channels; base channels kept; every other channel zero."""
    base_idx = _ids(base_ids, logits.device)
    base = logits[..., base_idx]  # [N, H, W, B]
    if similarity_seg.dim() > 2:
        novel = torch.einsum("nvb,nhwb->nhwv", similarity_seg, base)
    else:
        novel = torch.einsum("vb,nhwb->nhwv", similarity_seg, base)
    out = torch.zeros_like(logits)
    out[..., _ids(novel_ids, logits.device)] = novel
    out[..., base_idx] = base
    return out


def crop_mask_to_box(
    gt_mask: torch.Tensor,   # [N, Mg, Mg] masks in their GT boxes' frames (0..1)
    gt_box: torch.Tensor,    # [N, 4] those frames
    roi_box: torch.Tensor,   # [N, 4] the boxes to crop
    out_size: int,
) -> torch.Tensor:
    """Each GT-box-frame mask sampled bilinearly on its ROI's out_size grid:
    [N, out_size, out_size], zero where the sample lies more than a cell
    outside the mask."""
    n, mg = gt_mask.shape[0], gt_mask.shape[-1]
    gw = (gt_box[:, 2] - gt_box[:, 0]).clamp_min(1e-4)[:, None]
    gh = (gt_box[:, 3] - gt_box[:, 1]).clamp_min(1e-4)[:, None]
    grid = (torch.arange(out_size, dtype=torch.float32, device=gt_mask.device) + 0.5) / out_size
    ys = roi_box[:, 1:2] + grid * (roi_box[:, 3:4] - roi_box[:, 1:2])  # [N, out]
    xs = roi_box[:, 0:1] + grid * (roi_box[:, 2:3] - roi_box[:, 0:1])
    fy = (ys - gt_box[:, 1:2]) / gh * mg - 0.5
    fx = (xs - gt_box[:, 0:1]) / gw * mg - 0.5
    y0 = torch.floor(fy).clamp(0, mg - 1)
    x0 = torch.floor(fx).clamp(0, mg - 1)
    y1 = (y0 + 1).clamp(0, mg - 1)
    x1 = (x0 + 1).clamp(0, mg - 1)
    wy = (fy - y0).clamp(0, 1)[:, :, None]
    wx = (fx - x0).clamp(0, 1)[:, None, :]
    oob = ((fy < -1) | (fy > mg))[:, :, None] | ((fx < -1) | (fx > mg))[:, None, :]
    rows = torch.arange(n, device=gt_mask.device)[:, None, None]

    def at(yi, xi):
        return gt_mask[rows, yi.long()[:, :, None], xi.long()[:, None, :]]

    val = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
           + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
    return torch.where(oob, 0.0, val)


def _own_class(mask_logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """[N, M, M, C] logits -> [N, M, M], each ROI's channel of its class."""
    n, m, _, c = mask_logits.shape
    idx = classes.long().clamp(0, c - 1)[:, None, None, None].expand(n, m, m, 1)
    return mask_logits.gather(-1, idx)[..., 0]


def mask_rcnn_loss(
    mask_logits: torch.Tensor,   # [N, M, M, C]
    pred_classes: torch.Tensor,  # [N] the GT class of each proposal
    gt_masks: torch.Tensor,      # [N, Mg, Mg] its matched GT mask (GT-box frame)
    gt_boxes: torch.Tensor,      # [N, 4]
    roi_boxes: torch.Tensor,     # [N, 4]
    fg_valid: torch.Tensor,      # [N]
) -> torch.Tensor:
    """Per-class binary cross-entropy over the foreground proposals, each
    proposal's mean over its M x M cells, averaged over the foreground of the
    global batch (``global_normalizer``: a collective under data parallelism)."""
    sel = _own_class(mask_logits, pred_classes)
    targets = (crop_mask_to_box(gt_masks, gt_boxes, roi_boxes, sel.shape[-1]) > 0.5).float()
    bce = torch.relu(sel) - sel * targets + torch.log1p(torch.exp(-sel.abs()))
    per = bce.mean(dim=(1, 2))
    num = torch.where(fg_valid, per, 0.0).sum()
    return num / global_normalizer(fg_valid.float().sum())


def mask_rcnn_inference(mask_logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """The sigmoid of each detection's own class channel -> [N, M, M]."""
    return torch.sigmoid(_own_class(mask_logits, classes))
