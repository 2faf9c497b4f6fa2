"""Region Proposal Network: head, losses and proposal selection.

Port of unit_tpu/models/rpn.py: a 3x3 conv head over res4; anchor labelling
with the low-quality-match rescue and subsampled BCE objectness + smooth-L1
box losses normalised like detectron2; proposal selection (pre-NMS top-k ->
decode -> clip -> NMS (K3) -> post-NMS top-k) with fixed-size padded outputs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import anchors as anchor_ops
from ..ops import matcher as matcher_ops
from ..ops import nms as nms_ops
from ..ops import sampling as sampling_ops
from ..structures import boxes as box_ops
from ..structures.instances import GTInstances, Proposals, stack_fields
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
    iou_thresholds: Sequence[float] = (0.3, 0.7)
    iou_labels: Sequence[int] = (0, -1, 1)
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    bbox_reg_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    smooth_l1_beta: float = 0.0
    nms_thresh: float = 0.7
    pre_nms_topk_train: int = 12000
    pre_nms_topk_test: int = 6000
    post_nms_topk_train: int = 2000
    post_nms_topk_test: int = 1000
    min_size: float = 0.0
    loss_weight: float = 1.0

    @classmethod
    def from_cfg(cls, cfg) -> "RPNConfig":
        return cls(
            sizes=tuple(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]),
            aspect_ratios=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            iou_thresholds=tuple(cfg.MODEL.RPN.IOU_THRESHOLDS),
            iou_labels=tuple(cfg.MODEL.RPN.IOU_LABELS),
            batch_size_per_image=cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE,
            positive_fraction=cfg.MODEL.RPN.POSITIVE_FRACTION,
            bbox_reg_weights=tuple(cfg.MODEL.RPN.BBOX_REG_WEIGHTS),
            smooth_l1_beta=cfg.MODEL.RPN.SMOOTH_L1_BETA,
            nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
            pre_nms_topk_train=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
            pre_nms_topk_test=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
            post_nms_topk_train=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN,
            post_nms_topk_test=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
            min_size=float(cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE),
            loss_weight=cfg.MODEL.RPN.LOSS_WEIGHT,
        )

    @property
    def num_cell_anchors(self) -> int:
        return len(self.sizes) * len(self.aspect_ratios)


def get_anchors(feat_h: int, feat_w: int, cfg: RPNConfig, device=None) -> torch.Tensor:
    return anchor_ops.grid_anchors(feat_h, feat_w, cfg.stride, cfg.sizes,
                                   cfg.aspect_ratios, device=device)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    diff = (pred - target).abs()
    if beta <= 1e-5:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def label_anchors(
    generator: Optional[torch.Generator], anchors: torch.Tensor, gt: GTInstances,
    cfg: RPNConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image: (labels [N] in {-1, 0, 1} after subsampling, matched gt
    boxes [N, 4])."""
    iou = box_ops.pairwise_iou(gt.boxes, anchors)
    m = matcher_ops.match(iou, gt.valid, cfg.iou_thresholds, cfg.iou_labels, True)
    pos_sel, neg_sel = sampling_ops.subsample_label_masks(
        generator, m.labels == 1, m.labels == 0, cfg.batch_size_per_image,
        cfg.positive_fraction,
    )
    labels = torch.where(pos_sel, 1, torch.where(neg_sel, 0, -1))
    return labels, gt.boxes[m.matches]


def rpn_losses(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,   # [B, N]
    deltas: torch.Tensor,   # [B, N, 4]
    anchors: torch.Tensor,  # [N, 4]
    gt: GTInstances,        # batched: [B, G, ...]
    cfg: RPNConfig,
) -> Dict[str, torch.Tensor]:
    """Batched RPN losses, normalised like detectron2: sums over the sampled
    anchors / (B * batch_size_per_image)."""
    b = logits.shape[0]
    labels, matched = (torch.stack(x) for x in zip(*[
        label_anchors(generator, anchors, GTInstances(gt.boxes[i], gt.classes[i], gt.valid[i]),
                      cfg)
        for i in range(b)]))
    pos = labels == 1
    gt_deltas = box_ops.get_deltas(anchors[None], matched, cfg.bbox_reg_weights)
    normalizer = float(b * cfg.batch_size_per_image)

    loc = smooth_l1(deltas, gt_deltas, cfg.smooth_l1_beta).sum(-1)
    loss_loc = torch.where(pos, loc, 0.0).sum() / normalizer
    # stable BCE with logits against {0, 1} targets
    obj = logits.clamp_min(0) - logits * pos.float() + torch.log1p(torch.exp(-logits.abs()))
    loss_obj = torch.where(labels >= 0, obj, 0.0).sum() / normalizer
    return {"loss_rpn_cls": loss_obj * cfg.loss_weight,
            "loss_rpn_loc": loss_loc * cfg.loss_weight}


def select_proposals(
    logits: torch.Tensor,       # [B, N]
    deltas: torch.Tensor,       # [B, N, 4]
    anchors: torch.Tensor,      # [N, 4]
    image_sizes: torch.Tensor,  # [B, 2] true (H, W) within the padded canvas
    cfg: RPNConfig,
    nms_impl: str = "auto",
    training: bool = False,
) -> Proposals:
    """Proposal selection with min(pre_k, post_k) slots per image; the
    training top-k (12000 -> 2000 in the recipe) or the test one."""
    pre_k = min(cfg.pre_nms_topk_train if training else cfg.pre_nms_topk_test,
                logits.shape[1])
    post_k = cfg.post_nms_topk_train if training else cfg.post_nms_topk_test
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
