"""PCL (Proposal Cluster Learning) weak-detector path, static shapes.

Port of unit_tpu/models/pcl.py: graph construction and greedy center
extraction, the k-means top-ranking filter (ops/kmeans.py), PCL's
proposal-to-cluster targets and the PCL loss as a differentiable masked
formula (autograd reproduces PCLFunction's hand-written gradient).

Every function works on a batch of rows.  ``pcl_detector_losses`` mines all
OICR iterations at once: the mining input of iteration k (the MIL scores,
then the softmax of iteration k - 1's logits) is an output of the same
forward pass, so the rows are (iteration, image) pairs, as unit_tpu vmaps
over images.  Classes are mined in ascending order (proposals claimed by a
class are not available to later ones); the loop runs in Python over the
classes present in some image, which the caller reads from the host copy of
the labels, so mining adds no host sync.  An absent class changes nothing.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..ops import matcher as matcher_ops
from ..ops.kmeans import top_cluster_mask
from ..structures import boxes as box_ops
from .weak_losses import WeakLossConfig, binary_cross_entropy, mil_image_scores

EPS = 1e-9


class PCLClusters(NamedTuple):
    """Padded pseudo-GT cluster centers of each row: capacity K = C *
    max_pc_num (max_pc_num centers a class, classes in order)."""

    boxes: torch.Tensor    # [..., K, 4]
    classes: torch.Tensor  # [..., K] int64
    scores: torch.Tensor   # [..., K]
    valid: torch.Tensor    # [..., K]


def present_classes(labels: torch.Tensor) -> Sequence[int]:
    """The classes present (label > 0.5) in some row of ``labels`` [..., C],
    ascending.  Give it a CPU tensor (the batch's host copy): on a CUDA
    tensor it waits for the device."""
    return sorted(set(torch.nonzero(labels.detach().reshape(-1, labels.shape[-1]) > 0.5)[:, 1]
                      .tolist()))


def _extract_graph_centers(
    over: torch.Tensor,      # [R, P, P] pairwise IoU above the graph threshold
    probs_c: torch.Tensor,   # [R, P] this class's probabilities
    cand: torch.Tensor,      # [R, P] candidates (k-means top cluster)
    max_pc_num: int,
    max_center_iters: int,
):
    """Greedy max-degree center extraction, statically bounded.

    The do-while of the reference (the first center always, then more while
    over 5 candidates remain) runs all ``max_center_iters`` steps with
    ``torch.where`` and no early exit.  Once a row stops it never goes on
    (nothing changes), so step t's center is the row's t-th: the slots are
    the steps.  unit_tpu carries the live adjacency ``adj0 & alive_i &
    alive_j`` from step to step; here each step reads ``adj0 & alive_j`` and
    masks the dead rows, which gives the same degrees.

    Returns (center index [R, max_pc_num], scores, valid, used [R, P]).
    """
    r, p = cand.shape
    adj0 = over & cand[:, :, None] & cand[:, None, :]
    ar = torch.arange(p, device=cand.device)
    # a center's neighbourhood includes itself, even at zero area (unit_tpu
    # ORs it in); the degree counts the graph's own diagonal only
    with_self = adj0 | ((ar[:, None] == ar) & cand[:, :, None])
    alive = cand
    centers, scores, gos = [], [], []
    for t in range(max_center_iters):
        count = alive.sum(-1)
        go = count > 0 if t == 0 else count > 5
        degree = (adj0 & alive[:, None, :]).sum(-1)
        center = torch.where(alive, degree, -1).argmax(-1)  # first maximum
        nbr = alive & with_self.gather(1, center[:, None, None].expand(r, 1, p))[:, 0]
        scores.append(torch.where(nbr, probs_c, float("-inf")).amax(-1))
        alive = alive ^ (nbr & go[:, None])  # nbr lies within alive
        centers.append(center)
        gos.append(go)
    c_valid = torch.stack(gos, -1)
    c_idx = torch.where(c_valid, torch.stack(centers, -1), 0)
    c_score = torch.where(c_valid, torch.stack(scores, -1), float("-inf"))

    # the top-max_pc_num centers by score, ties to the lower slot (top_k)
    order = torch.sort(c_score, dim=-1, descending=True, stable=True).indices[:, :max_pc_num]
    top_scores = c_score.gather(1, order)
    sel_idx = c_idx.gather(1, order)
    sel_valid = torch.isfinite(top_scores) & c_valid.gather(1, order)
    used = ((sel_idx[:, :, None] == ar) & sel_valid[:, :, None]).any(1)
    # unit_tpu marks ``used`` by a scatter with duplicate indices
    # (unit_tpu/models/pcl.py:91): the padded slots point at proposal 0 and
    # come last, so with fewer than max_pc_num centers their False is the
    # last write to index 0 and a center at proposal 0 stays available to
    # later classes.  Kept here for parity, without a duplicate-index scatter.
    used[:, 0] &= sel_valid.all(-1)
    return sel_idx, torch.where(sel_valid, top_scores, 0.0), sel_valid, used


def mine_pcl_clusters(
    scores: torch.Tensor,     # [R, P, C'] mining distribution (read without gradient)
    proposals: torch.Tensor,  # [R, P, 4]
    valid: torch.Tensor,      # [R, P]
    labels: torch.Tensor,     # [R, C]
    cfg: WeakLossConfig,
    present: Sequence[int],
    num_kmeans_cluster: int = 3,
    graph_iou_threshold: float = 0.4,
    max_pc_num: int = 5,
    max_center_iters: int = 32,
    over: torch.Tensor = None,
) -> PCLClusters:
    """Per-class k-means filter + graph-center extraction over the rows;
    chosen proposals are removed before the next class.  ``present``: the
    classes present in some row, ascending (:func:`present_classes`); the
    others get no centers.  ``over`` ([R, P, P] IoU above the threshold) may
    be given when rows share proposals."""
    c = cfg.num_classes
    r, p = valid.shape
    s = scores[..., :c].detach().clamp(EPS, 1 - EPS)
    if over is None:
        over = box_ops.pairwise_iou(proposals, proposals) > graph_iou_threshold
    # absent classes: unit_tpu's extraction with no candidate, proposal 0's
    # box in every slot, score 0, invalid
    idx = torch.zeros((r, c, max_pc_num), dtype=torch.int64, device=valid.device)
    out_scores = s.new_zeros((r, c, max_pc_num))
    out_valid = torch.zeros((r, c, max_pc_num), dtype=torch.bool, device=valid.device)
    avail = valid
    for cls in present:
        here = labels[:, cls] > 0.5
        col = s[:, :, cls]
        cand = top_cluster_mask(torch.where(avail, col, float("-inf")), avail,
                                k=num_kmeans_cluster)
        cand = cand & avail & here[:, None]
        idx[:, cls], out_scores[:, cls], v, used = _extract_graph_centers(
            over, col, cand, max_pc_num, max_center_iters)
        out_valid[:, cls] = v & here[:, None]
        avail = avail & ~(used & here[:, None])
    idx = idx.reshape(r, -1)
    classes = torch.arange(c, device=valid.device).repeat_interleave(max_pc_num)
    return PCLClusters(
        boxes=proposals.gather(1, idx[:, :, None].expand(-1, -1, 4)),
        classes=classes.expand(r, -1),
        scores=out_scores.reshape(r, -1),
        valid=out_valid.reshape(r, -1),
    )


def pcl_targets(clusters: PCLClusters, proposals: torch.Tensor, valid: torch.Tensor,
                cfg: WeakLossConfig):
    """Proposal -> cluster assignment with PCL's fg/bg/ignore rules
    (compute_pcl_loss_inputs) over rows: proposals [R, P, 4] ->
    (labels [R, P] with bg = C, weights [R, P], cluster index or -1 [R, P])."""
    iou = box_ops.pairwise_iou(clusters.boxes, proposals)
    m = matcher_ops.match(iou, clusters.valid, [cfg.fg_threshold], [0, 1], False)
    p_labels = torch.where(m.labels == 1, clusters.classes.gather(1, m.matches),
                           cfg.num_classes)
    weights = clusters.scores.gather(1, m.matches)
    weights = torch.where(m.vals < cfg.bg_threshold, 0.0, weights)  # ignored
    assignment = torch.where(m.vals < cfg.fg_threshold, -1, m.matches)  # background
    p_labels = torch.where(valid, p_labels, cfg.num_classes)
    weights = torch.where(valid, weights, 0.0)
    assignment = torch.where(valid, assignment, -1)
    return p_labels, weights, assignment


def pcl_loss(
    logits: torch.Tensor,      # [R, P, C+1] the OICR iteration's logits (live)
    clusters: PCLClusters,
    p_labels: torch.Tensor,    # [R, P]
    weights: torch.Tensor,     # [R, P]
    assignment: torch.Tensor,  # [R, P] cluster index or -1
    valid: torch.Tensor,       # [R, P]
    num_classes: int,
) -> torch.Tensor:
    """PCLFunction's loss of each row [R]: each foreground cluster's weight
    times the log of its members' mean probability of its class, and each
    background proposal's weight times the log of its background
    probability, over the valid proposals."""
    probs = F.softmax(logits, dim=-1).clamp(EPS, 1 - EPS)
    k = clusters.boxes.shape[-2]
    member = ((assignment[:, None, :] == torch.arange(k, device=logits.device)[:, None])
              & valid[:, None, :]).to(probs.dtype)  # [R, K, P]
    count = member.sum(-1)
    img_cls_weights = (member * weights[:, None, :]).sum(-1)
    # [R, K, P]: each cluster's row of probabilities of its class
    prob_of_cls = probs.transpose(1, 2).gather(
        1, clusters.classes[:, :, None].expand(-1, -1, probs.shape[1]))
    pc_probs = (member * prob_of_cls).sum(-1) / count.clamp_min(1.0)
    fg_term = torch.where(clusters.valid & (count > 0),
                          img_cls_weights * torch.log(pc_probs.clamp_min(EPS)), 0.0).sum(-1)
    is_bg = (p_labels == num_classes) & valid
    bg_term = torch.where(is_bg, weights * torch.log(probs[..., num_classes]), 0.0).sum(-1)
    n_valid = valid.to(probs.dtype).sum(-1).clamp_min(1.0)
    return -(fg_term + bg_term) / n_valid


def pcl_detector_losses(
    streams: Dict,             # WeakDetectorPredictor.forward output, leading dim B*P
    proposals: torch.Tensor,   # [B, P, 4]
    valid: torch.Tensor,       # [B, P]
    labels: torch.Tensor,      # [B, C]
    cfg: WeakLossConfig,
    present: Sequence[int],
    num_kmeans_cluster: int = 3,
    graph_iou_threshold: float = 0.4,
    max_pc_num: int = 5,
) -> Dict[str, torch.Tensor]:
    """The weak branch's losses with WEAK_DETECTOR.TYPE PCL: loss_im_cls (MIL)
    and loss_oicr_{1..K} (PCL), each times ``weak_loss_multiplier``.
    ``present``: the classes present in some image, ascending, from the
    host copy of ``labels`` (:func:`present_classes`)."""
    b, p, _ = proposals.shape
    c, iters = cfg.num_classes, cfg.oicr_iter

    def per_image(x):
        return x.reshape(b, p, -1)

    mil_scores, class_vectors = mil_image_scores(
        per_image(streams["classifier_stream"]), per_image(streams["detection_stream"]),
        valid)
    losses = {"loss_im_cls": binary_cross_entropy(class_vectors, labels) * cfg.mil_multiplier}

    # rows (iteration, image): iteration 1 mines the MIL scores, iteration k
    # the softmax of iteration k - 1's logits
    logits = torch.stack([per_image(x) for x in streams["oicr_scores"][:iters]])
    with torch.no_grad():
        prev = torch.cat([mil_scores[None, ..., :c],
                          F.softmax(logits[:-1], dim=-1)[..., :c]]).flatten(0, 1)

    def rows(x):
        return x.expand(iters, *x.shape).flatten(0, 1)

    props, val = rows(proposals), rows(valid)
    over = rows(box_ops.pairwise_iou(proposals, proposals) > graph_iou_threshold)
    clusters = mine_pcl_clusters(prev, props, val, rows(labels), cfg, present,
                                 num_kmeans_cluster, graph_iou_threshold, max_pc_num,
                                 over=over)
    p_labels, weights, assignment = pcl_targets(clusters, props, val, cfg)
    per_row = pcl_loss(logits.flatten(0, 1), clusters, p_labels, weights, assignment, val, c)
    for k, loss_k in enumerate(per_row.reshape(iters, b).mean(-1)):
        losses[f"loss_oicr_{k + 1}"] = loss_k
    return {k: v * cfg.weak_loss_multiplier for k, v in losses.items()}
