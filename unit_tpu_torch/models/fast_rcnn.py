"""Fast R-CNN losses and inference (static shapes).

Port of unit_tpu/models/fast_rcnn.py: the supervised losses (CE mean over
the sampled slots plus class-specific smooth-L1 over the foreground, both
divided by the slot count), the novel-class mask of base training, and
inference: score threshold -> per-class NMS (class-offset trick) -> top-k
with a fixed number of detection slots.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..ops import nms as nms_ops
from ..parallel.comm import global_normalizer
from ..structures import boxes as box_ops
from ..structures.instances import Detections, SampledProposals

NEG_INF = -1e8  # novel-class logit during base training (the reference uses -inf)


class FastRCNNConfig(NamedTuple):
    num_classes: int
    bbox_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0)
    smooth_l1_beta: float = 0.0
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    topk_per_image: int = 100

    @classmethod
    def from_cfg(cls, cfg) -> "FastRCNNConfig":
        return cls(
            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
            bbox_reg_weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
            smooth_l1_beta=cfg.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA,
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        )


def fast_rcnn_losses(
    scores: torch.Tensor,           # [N, C+1], novel columns already masked
    proposal_deltas: torch.Tensor,  # [N, C*4]
    sampled: SampledProposals,      # flattened batch (leading N)
    cfg: FastRCNNConfig,
) -> Dict[str, torch.Tensor]:
    """CE (mean over the valid slots) + class-specific smooth-L1 (sum over
    the foreground / valid slots): FastRCNNOutputs' two losses.  The valid
    slots are counted over the global batch (``global_normalizer``): a
    collective under data parallelism."""
    c = cfg.num_classes
    valid = sampled.valid
    n_valid = global_normalizer(valid.float().sum())

    logp = F.log_softmax(scores, dim=-1)
    nll = -logp.gather(1, sampled.gt_classes.clamp(0, c)[:, None])[:, 0]
    loss_cls = torch.where(valid, nll, 0.0).sum() / n_valid

    gt_deltas = box_ops.get_deltas(sampled.boxes, sampled.gt_boxes, cfg.bbox_reg_weights)
    d4 = proposal_deltas.reshape(-1, c, 4)
    cls_idx = sampled.gt_classes.clamp(0, c - 1)
    sel = d4.gather(1, cls_idx[:, None, None].expand(-1, 1, 4))[:, 0]
    diff = (sel - gt_deltas).abs()
    beta = cfg.smooth_l1_beta
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta) \
        if beta > 1e-5 else diff
    fg = sampled.is_fg & valid
    loss_box = torch.where(fg[:, None], loss, 0.0).sum() / n_valid
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


def mask_novel_scores(scores: torch.Tensor, novel_ids: Sequence[int]) -> torch.Tensor:
    """Novel-class logits -> NEG_INF during base training."""
    if not len(novel_ids):
        return scores
    mask = torch.zeros(scores.shape[-1], dtype=torch.bool, device=scores.device)
    mask[list(novel_ids)] = True
    return torch.where(mask, NEG_INF, scores)


def fast_rcnn_inference_single(
    probs: torch.Tensor,            # [P, C+1] softmaxed scores
    proposal_deltas: torch.Tensor,  # [P, C*4]
    proposal_boxes: torch.Tensor,   # [P, 4]
    proposal_valid: torch.Tensor,   # [P]
    image_size,                     # (H, W): numbers or 0-d tensors
    cfg: FastRCNNConfig,
    nms_impl: str = "auto",
) -> Detections:
    """fast_rcnn_inference for one image with min(P*C, topk) output slots."""
    p = probs.shape[0]
    c = cfg.num_classes
    boxes = box_ops.apply_deltas(proposal_deltas, proposal_boxes, cfg.bbox_reg_weights)
    boxes = box_ops.clip_boxes(boxes.reshape(p, c, 4), image_size)

    scores = probs[:, :c]  # drop the background column
    keep = (scores > cfg.score_thresh) & proposal_valid[:, None]

    flat_boxes = boxes.reshape(p * c, 4)
    flat_scores = scores.reshape(p * c)
    flat_classes = torch.arange(c, device=probs.device).repeat(p)
    idx, ok = nms_ops.batched_nms(
        flat_boxes, flat_scores, flat_classes, cfg.nms_thresh, cfg.topk_per_image,
        valid=keep.reshape(p * c), impl=nms_impl,
    )
    return Detections(
        boxes=flat_boxes[idx],
        scores=torch.where(ok, flat_scores[idx], 0.0),
        classes=flat_classes[idx],
        valid=ok,
    )
