"""Fast R-CNN inference (static shapes).

Port of unit_tpu/models/fast_rcnn.py:24-111: score threshold -> per-class
NMS (class-offset trick) -> top-k with a fixed number of detection slots.
The losses belong to the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..ops import nms as nms_ops
from ..structures import boxes as box_ops
from ..structures.instances import Detections


class FastRCNNConfig(NamedTuple):
    num_classes: int
    bbox_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    topk_per_image: int = 100

    @classmethod
    def from_cfg(cls, cfg) -> "FastRCNNConfig":
        return cls(
            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
            bbox_reg_weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        )


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
