"""Region Proposal Network head and test-time proposal selection.

Port of unit_tpu/models/rpn.py:30-99,161-190: a 3x3 conv head over res4 and
proposal selection (pre-NMS top-k -> decode -> clip -> NMS -> post-NMS top-k)
with fixed-size padded outputs.  The RPN losses belong to the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import anchors as anchor_ops
from ..ops import nms as nms_ops
from ..structures import boxes as box_ops
from ..structures.instances import Proposals, stack_fields
from .resnet import Conv2d


class RPNHead(nn.Module):
    """Shared 3x3 conv, 1x1 objectness + 1x1 anchor deltas (normal(0.01) init)."""

    def __init__(self, in_channels: int, num_anchors: int, conv_dim: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_anchors = num_anchors
        kw = dict(bias=True, dtype=dtype, init_std=0.01, generator=generator)
        self.conv = Conv2d(in_channels, conv_dim, 3, padding=1, **kw)
        self.objectness_logits = Conv2d(conv_dim, num_anchors, 1, **kw)
        self.anchor_deltas = Conv2d(conv_dim, num_anchors * 4, 1, **kw)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """features [B, H, W, C] -> (logits [B, H*W*A], deltas [B, H*W*A, 4]), f32."""
        t = F.relu(self.conv(features.permute(0, 3, 1, 2)))
        logits = self.objectness_logits(t).permute(0, 2, 3, 1)
        deltas = self.anchor_deltas(t).permute(0, 2, 3, 1)
        b, h, w, _ = logits.shape
        a = self.num_anchors
        return (logits.reshape(b, h * w * a).float(),
                deltas.reshape(b, h * w * a, 4).float())


class RPNConfig(NamedTuple):
    sizes: Sequence[float] = (32, 64, 128, 256, 512)
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0)
    stride: int = 16
    bbox_reg_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    nms_thresh: float = 0.7
    pre_nms_topk_test: int = 6000
    post_nms_topk_test: int = 1000
    min_size: float = 0.0

    @classmethod
    def from_cfg(cls, cfg) -> "RPNConfig":
        return cls(
            sizes=tuple(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]),
            aspect_ratios=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            bbox_reg_weights=tuple(cfg.MODEL.RPN.BBOX_REG_WEIGHTS),
            nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
            pre_nms_topk_test=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
            post_nms_topk_test=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
            min_size=float(cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE),
        )

    @property
    def num_cell_anchors(self) -> int:
        return len(self.sizes) * len(self.aspect_ratios)


def get_anchors(feat_h: int, feat_w: int, cfg: RPNConfig, device=None) -> torch.Tensor:
    return anchor_ops.grid_anchors(feat_h, feat_w, cfg.stride, cfg.sizes,
                                   cfg.aspect_ratios, device=device)


def select_proposals(
    logits: torch.Tensor,       # [B, N]
    deltas: torch.Tensor,       # [B, N, 4]
    anchors: torch.Tensor,      # [N, 4]
    image_sizes: torch.Tensor,  # [B, 2] true (H, W) within the padded canvas
    cfg: RPNConfig,
    nms_impl: str = "auto",
) -> Proposals:
    """Test-time proposal selection with min(pre_k, post_k) slots per image
    (the training-time top-k belongs to slice B)."""
    pre_k = min(cfg.pre_nms_topk_test, logits.shape[1])
    post_k = cfg.post_nms_topk_test
    out = []
    for lg, dl, hw in zip(logits, deltas, image_sizes):
        # stable descending sort = lax.top_k's order (ties: lower index first)
        scores, idx = torch.sort(lg, descending=True, stable=True)
        scores, idx = scores[:pre_k], idx[:pre_k]
        boxes = box_ops.apply_deltas(dl[idx], anchors[idx], cfg.bbox_reg_weights)
        boxes = box_ops.clip_boxes(boxes, (hw[0], hw[1]))
        keep = box_ops.nonempty(boxes, cfg.min_size) & torch.isfinite(scores)
        nms_idx, nms_valid = nms_ops.nms(boxes, scores, cfg.nms_thresh, post_k,
                                         valid=keep, impl=nms_impl)
        out.append(Proposals(boxes=boxes[nms_idx], objectness=scores[nms_idx],
                             valid=nms_valid))
    return stack_fields(out, Proposals)
