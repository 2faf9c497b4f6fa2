"""Weakly supervised detector losses (MIL + OICR), batched, static shapes.

Port of unit_tpu/models/weak_losses.py.  Every image has a fixed
proposal capacity P with a validity mask and its image-level labels are a
multi-hot vector, so the batch goes through as tensors:

  * MIL: per-image BCE between the sum over proposals of softmax_cls x
    softmax_det and the label vector;
  * OICR pseudo-GT mining: for each present class, in ascending order, the
    top proposal under the previous iteration's scores becomes a pseudo box
    whose score is the supervision weight, and its score row is zeroed
    before the next class;
  * OICR loss: proposals matched to a pseudo box at IoU >= fg threshold take
    its class, the rest background; the weight is the matched pseudo score,
    zeroed below the bg threshold; weighted CE, mean over proposals;
  * with WEAK_DETECTOR.REGRESSION_BRANCH, a Fast R-CNN loss of the branch
    against pseudo boxes mined from the mean of the OICR softmaxes: the
    weighted CE, and a class-specific L1 (smooth L1 under
    ROI_BOX_HEAD.SMOOTH_L1_BETA) on the foreground proposals over the valid
    count (set by no shipped config).

Mining runs on the device as a loop over classes over the whole batch; no
value comes back to the host.  With OICR_ITER 0 only the MIL loss remains.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..ops import matcher as matcher_ops
from ..structures import boxes as box_ops


class WeakLossConfig(NamedTuple):
    num_classes: int
    oicr_iter: int = 3
    fg_threshold: float = 0.5   # ROI_HEADS.IOU_THRESHOLDS[0]
    bg_threshold: float = 0.1   # WEAK_DETECTOR.BG_THRESHOLD (weight zeroing)
    mil_multiplier: float = 1.0
    weak_loss_multiplier: float = 1.0
    bbox_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0)  # ROI_BOX_HEAD's
    smooth_l1_beta: float = 0.0                                 # ROI_BOX_HEAD's
    regression_branch: bool = False
    oicr_regression_branch: bool = False


class PseudoGT(NamedTuple):
    boxes: torch.Tensor   # [..., C, 4] per-class top proposal
    scores: torch.Tensor  # [..., C] its score under the mining distribution
    valid: torch.Tensor   # [..., C] class present in the image


def mil_image_scores(cls_logits: torch.Tensor, det_logits: torch.Tensor,
                     valid: torch.Tensor):
    """Two-stream MIL over [..., P, C] logits and [..., P] valid: softmax
    over classes times softmax over valid proposals.  Returns (mil scores
    [..., P, C], class vector [..., C])."""
    s_cls = F.softmax(cls_logits, dim=-1)
    det = torch.where(valid[..., None], det_logits, float("-inf"))
    s_det = torch.where(valid[..., None], F.softmax(det, dim=-2), 0.0)
    x_r = torch.where(valid[..., None], s_cls * s_det, 0.0)
    return x_r, x_r.sum(dim=-2)


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Element-mean BCE on probabilities clamped to [eps, 1 - eps]."""
    p = probs.clamp(eps, 1.0 - eps)
    return (-(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))).mean()


def mine_pseudo_gt(scores: torch.Tensor, proposals: torch.Tensor, valid: torch.Tensor,
                   labels: torch.Tensor, num_classes: int) -> PseudoGT:
    """get_proposal_clusters over a batch: scores [B, P, C'] (C' >= C, read
    without gradient), proposals [B, P, 4], valid [B, P], labels [B, C].

    Classes in ascending order: the argmax proposal of the class column
    (first index among ties) becomes its pseudo box, then that proposal's
    row is zeroed so later classes do not pick it again.
    """
    s = torch.where(valid[..., None], scores[..., :num_classes].detach(), -1.0)
    b, p = s.shape[:2]
    rows = torch.arange(p, device=s.device)
    present = labels > 0.5
    boxes, out_scores = [], []
    for c in range(num_classes):
        col = s[:, :, c]
        best, idx = col.max(dim=1)
        here = present[:, c]
        boxes.append(torch.where(here[:, None],
                                 proposals.gather(1, idx[:, None, None].expand(-1, 1, 4))[:, 0],
                                 0.0))
        out_scores.append(torch.where(here, best, 0.0))
        s = torch.where(((rows[None] == idx[:, None]) & here[:, None])[..., None], 0.0, s)
    return PseudoGT(boxes=torch.stack(boxes, 1), scores=torch.stack(out_scores, 1),
                    valid=present)


def oicr_targets(pseudo: PseudoGT, proposals: torch.Tensor, valid: torch.Tensor,
                 cfg: WeakLossConfig):
    """One image: label proposals [P, 4] against pseudo GT [C, ...].

    Returns (labels [P] with bg = C, weights [P], matched slot [P], vals [P]).
    """
    iou = box_ops.pairwise_iou(pseudo.boxes, proposals)
    m = matcher_ops.match(iou, pseudo.valid, [cfg.fg_threshold], [0, 1], False)
    labels = torch.where(m.labels == 1, m.matches, cfg.num_classes)
    weights = pseudo.scores[m.matches]
    if cfg.bg_threshold > 0.0:
        weights = torch.where(m.vals < cfg.bg_threshold, 0.0, weights)
    weights = torch.where(valid, weights, 0.0)
    labels = torch.where(valid, labels, cfg.num_classes)
    return labels, weights, m.matches, m.vals


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Weighted softmax CE over [P, C+1] logits, mean over the valid proposals."""
    nll = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    num = torch.where(valid, nll * weights, 0.0).sum()
    return num / valid.float().sum().clamp_min(1.0)


def weak_detector_losses(
    streams: Dict,            # WeakDetectorPredictor.forward output, leading dim B*P
    proposals: torch.Tensor,  # [B, P, 4]
    valid: torch.Tensor,      # [B, P]
    labels: torch.Tensor,     # [B, C] multi-hot image labels
    cfg: WeakLossConfig,
) -> Dict[str, torch.Tensor]:
    """The weak branch's loss dict, OICR path: loss_im_cls, loss_oicr_{1..K}
    and, with the regression branch, loss_regression_cls and
    loss_regression_bbox, each times ``weak_loss_multiplier``."""
    b, p, _ = proposals.shape
    c = cfg.num_classes

    def per_image(x):
        return x.reshape(b, p, -1)

    mil_scores, class_vectors = mil_image_scores(
        per_image(streams["classifier_stream"]), per_image(streams["detection_stream"]),
        valid)
    losses = {"loss_im_cls": binary_cross_entropy(class_vectors, labels) * cfg.mil_multiplier}

    prev = mil_scores.detach()
    for k in range(cfg.oicr_iter):
        logits_k = per_image(streams["oicr_scores"][k])
        pseudo = mine_pseudo_gt(prev, proposals, valid, labels, c)
        per = []
        for i in range(b):
            t_labels, t_weights, _, _ = oicr_targets(
                PseudoGT(pseudo.boxes[i], pseudo.scores[i], pseudo.valid[i]),
                proposals[i], valid[i], cfg)
            per.append(weighted_ce(logits_k[i], t_labels, t_weights, valid[i]))
        losses[f"loss_oicr_{k + 1}"] = torch.stack(per).mean()
        prev = F.softmax(logits_k, dim=-1).detach()
    if cfg.regression_branch:
        losses.update(_regression_branch_losses(streams, proposals, valid, labels, cfg))
    return {k: v * cfg.weak_loss_multiplier for k, v in losses.items()}


def _regression_branch_losses(streams: Dict, proposals: torch.Tensor, valid: torch.Tensor,
                              labels: torch.Tensor, cfg: WeakLossConfig
                              ) -> Dict[str, torch.Tensor]:
    """The regression branch's Fast R-CNN losses against the pseudo boxes of
    the OICR-mean scores, each the mean over the images."""
    b, p, _ = proposals.shape
    c = cfg.num_classes
    oicr_mean = torch.stack([F.softmax(s.reshape(b, p, -1), dim=-1)
                             for s in streams["oicr_scores"]]).mean(0).detach()
    reg_cls = streams["regression_cls"].reshape(b, p, -1)
    reg_bbox = streams["regression_bbox"].reshape(b, p, c, 4)
    pseudo = mine_pseudo_gt(oicr_mean, proposals, valid, labels, c)
    cls_losses, bbox_losses = [], []
    for i in range(b):
        t_labels, t_weights, slot, _ = oicr_targets(
            PseudoGT(pseudo.boxes[i], pseudo.scores[i], pseudo.valid[i]),
            proposals[i], valid[i], cfg)
        cls_losses.append(weighted_ce(reg_cls[i], t_labels, t_weights, valid[i]))
        gt_deltas = box_ops.get_deltas(proposals[i], pseudo.boxes[i][slot],
                                       cfg.bbox_reg_weights)
        fg = (t_labels < c) & valid[i]
        sel = reg_bbox[i].gather(1, t_labels.clamp(0, c - 1)[:, None, None].expand(-1, 1, 4))
        diff = (sel[:, 0] - gt_deltas).abs()
        beta = cfg.smooth_l1_beta
        loss = (torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
                if beta > 1e-5 else diff)
        bbox_losses.append(torch.where(fg[:, None], loss, 0.0).sum()
                           / valid[i].float().sum().clamp_min(1.0))
    return {"loss_regression_cls": torch.stack(cls_losses).mean(),
            "loss_regression_bbox": torch.stack(bbox_losses).mean()}
