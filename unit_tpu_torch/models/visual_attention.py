"""The visual attention (support-prototype) head of the meta recipe.

Port of unit_tpu/models/visual_attention.py.  Support shots are pooled at
their GT boxes (ROIAlignV2, kernel K1: one launch over all C x K shots,
whatever MODEL.ROI_BOX_HEAD.POOLER_TYPE says, as in unit_tpu: the dock's
ROIPool model pools its shots through K1 too) and go through a meta box
head of their own (a Res5 over the backbone's channels); each class gets a
prototype mean, and in the Mahalanobis mode a diagonal covariance inverse.
Query ROIs, through the same meta head, are scored against the prototypes
by ``likelihood`` and trained by the margin, regression and prototype
classification rank losses (``rank_loss``).  Four modes, from
MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.NAME:

    mean          MeanSimilarity: identity covariance, Gaussian likelihood
    mahalanobis   MahalanobisSimilarity: diagonal covariance 1 / (var + 1)
    matrix        MeanMatrixSimilarity: a learned D x D matrix on the means
                  (normalised as unit_tpu does: ``support_prototypes``),
                  cosine similarity through a ReLU
    locatron      MeanMatrixSimilarityLocatron: cosine similarity without the
                  ReLU, no prototype classification loss

The Gaussian likelihood underflows as unit_tpu's does (docs/DEVIATIONS.md):
with D = 2048 the normaliser exp(-0.5 D log 2 pi) is 0 in f32, so in the mean
and Mahalanobis modes every similarity is exactly 0, ``loss_rank_margin`` is
(S - 1) 0.5 / S and ``loss_rank_reg`` 1.0, both without gradient, and only
``loss_rank_cls`` trains the meta head.  The likelihood reads only the class
slots it is asked for, picked before the exponential, so the -inf log
determinant of a slot without support never enters a product or a gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import roi_align as roi_align_ops
from ..parallel.comm import global_normalizer
from .resnet import Res5

MODES = ("mean", "mahalanobis", "matrix", "locatron")


@dataclasses.dataclass(frozen=True)
class MetaAttention:
    """Per-class prototypes: mean [C+1, D], cov_inv [C+1, D] (the diagonal of
    the covariance inverse, ones outside the Mahalanobis mode) and logdet
    [C+1] (0 at the base classes and the background, -inf elsewhere)."""

    mean: torch.Tensor
    cov_inv: torch.Tensor
    logdet: torch.Tensor


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-6)


class VisualAttentionHead(nn.Module):
    """Meta box head + prototype construction + rank losses.

    ``meta_box_head`` is a Res5 with its own parameters, emitting
    D = 8 * res2_out_channels features; ``rank_loss_classifier`` a
    Linear(D, C+1) with normal(0.01) weights and a zero bias (not in the
    locatron mode, which has no classification loss, so that the parameters
    are unit_tpu's leaf for leaf); in the matrix modes ``sim_matrix`` a
    Linear(D, D) without bias, initialised to the identity.
    ``in_channels``: the backbone map's width, which the meta head's first
    block reads (None: ResNet-C4's 4 * res2_out_channels; 256, 512 or 1088
    over VGG-CNN-F, VGG16 or InceptionResNetV2).  ``roi_align_impl`` (auto |
    cuda | plain) picks K1 or its plain version for the support shots."""

    def __init__(self, num_classes: int, depth: int = 50, res2_out_channels: int = 256,
                 in_channels: Optional[int] = None, mode: str = "mean",
                 pooler_resolution: int = 14,
                 pooler_scale: float = 1.0 / 16.0, sampling_ratio: int = 2,
                 roi_align_impl: str = "auto", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown visual attention mode {mode!r} ({' | '.join(MODES)})")
        self.num_classes, self.mode = num_classes, mode
        self.pooler_resolution, self.pooler_scale = pooler_resolution, pooler_scale
        self.sampling_ratio, self.roi_align_impl = sampling_ratio, roi_align_impl
        self.meta_box_head = Res5(depth=depth, res2_out_channels=res2_out_channels,
                                  in_channels=in_channels, dtype=dtype, generator=generator)
        d = self.meta_box_head.out_channels
        if mode != "locatron":  # unit_tpu's locatron head never calls it: no parameters
            self.rank_loss_classifier = nn.utils.skip_init(nn.Linear, d, num_classes + 1)
            with torch.no_grad():
                self.rank_loss_classifier.weight.normal_(0.0, 0.01, generator=generator)
                self.rank_loss_classifier.bias.zero_()
        if self.is_matrix:
            self.sim_matrix = nn.utils.skip_init(nn.Linear, d, d, bias=False)
            with torch.no_grad():
                self.sim_matrix.weight.copy_(torch.eye(d))

    @property
    def is_matrix(self) -> bool:
        return self.mode in ("matrix", "locatron")

    def query_features(self, pooled: torch.Tensor) -> torch.Tensor:
        """Query ROI features [N, D] f32 through the meta head; the pooled
        maps are detached, so the rank losses train the meta head alone.  The
        matrix modes L2-normalise."""
        f = self.meta_box_head(pooled.detach()).to(torch.float32)
        return _l2_normalize(f) if self.is_matrix else f

    def support_prototypes(self, support_feats: torch.Tensor, support_boxes: torch.Tensor,
                           class_valid: torch.Tensor, base_ids: Sequence[int]) -> MetaAttention:
        """support_feats [C, K, h, w, ch] (the shots' backbone features),
        support_boxes [C, K, 4] (one GT box a shot, in shot pixels),
        class_valid [C] (the class has support), base_ids [C] (the dataset
        class of each row) -> the prototypes of all C + 1 slots."""
        c, k = support_feats.shape[:2]
        p = self.pooler_resolution
        # one launch over all C * K shots, one ROI each
        pooled = roi_align_ops.roi_align_batched(
            support_feats.reshape((c * k,) + support_feats.shape[2:]).contiguous(),
            support_boxes.reshape(c * k, 1, 4).to(torch.float32).contiguous(),
            p, self.pooler_scale, self.sampling_ratio, impl=self.roi_align_impl,
        ).reshape((c * k, p, p) + support_feats.shape[-1:])
        per_class = self.meta_box_head(pooled).to(torch.float32).reshape(c, k, -1)
        means = per_class.mean(dim=1)  # [C, D]
        if self.is_matrix:
            # the learned transform, then unit_tpu's normalisation, kept for
            # parity: its jnp.linalg.norm(means, -1, keepdims=True) passes -1
            # as the order, not the axis, so it divides every prototype by
            # one number, the matrix norm of order -1 (the smallest column
            # sum of |means|), where the reference normalises each row
            means = self.sim_matrix(means)
            means = means / means.abs().sum(dim=0).min().clamp_min(1e-6)
        if self.mode == "mahalanobis":
            # the diagonal covariance (correction 1), identity added before inversion
            cov_inv = 1.0 / (per_class.var(dim=1, correction=1) + 1.0)
        else:
            cov_inv = torch.ones_like(means)
        n_total, d = self.num_classes + 1, means.shape[-1]
        ids = torch.as_tensor(list(base_ids), dtype=torch.int64, device=means.device)
        valid = class_valid.to(device=means.device, dtype=torch.bool)
        zeros = means.new_zeros((n_total, d))
        mean_full = zeros.index_copy(0, ids, torch.where(valid[:, None], means, 0.0))
        cov_full = zeros.index_copy(0, ids, cov_inv)
        # the background slot: zero mean, identity covariance
        cov_full = cov_full.index_fill(0, ids.new_tensor([self.num_classes]), 1.0)
        logdet = means.new_full((n_total,), -math.inf)
        logdet[ids] = 0.0
        logdet[self.num_classes] = 0.0
        return MetaAttention(mean=mean_full, cov_inv=cov_full, logdet=logdet)

    def likelihood(self, attention: MetaAttention, query: torch.Tensor,
                   class_slots: Sequence[int]) -> torch.Tensor:
        """Similarity of each query feature [N, D] to each slot of
        ``class_slots``: [N, len(class_slots)].  The slots are picked before
        anything else is formed."""
        slots = torch.as_tensor(list(class_slots), dtype=torch.int64, device=query.device)
        mean = attention.mean[slots]
        if self.mode == "matrix":
            return torch.relu(query @ mean.T)
        if self.mode == "locatron":
            return query @ mean.T
        pi_normalizer = 0.5 * query.shape[-1] * math.log(2 * math.pi)
        cov_inv, logdet = attention.cov_inv[slots], attention.logdet[slots]
        diff = query[:, None, :] - mean[None, :, :]
        maha = (diff * diff * cov_inv[None]).sum(dim=-1)
        return torch.exp(0.5 * logdet[None] - pi_normalizer - 0.5 * maha)

    def rank_loss(self, pooled: torch.Tensor, gt_classes: torch.Tensor, valid: torch.Tensor,
                  attention: MetaAttention, base_ids: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The margin (hinge, margin 0.5), regression and prototype
        classification losses of query ROIs: pooled [N, P, P, ch] (the
        subsampled slots of the strong images), gt_classes [N], valid [N].
        The matrix modes fill the slots they do not score with -2, put 0.5 at
        the gt slot and take the regression loss over the foreground only."""
        feats = self.query_features(pooled)
        n, n_total = feats.shape[0], self.num_classes + 1
        slots = list(base_ids) if self.is_matrix else [*base_ids, self.num_classes]
        slot_ids = torch.as_tensor(slots, dtype=torch.int64, device=feats.device)
        gt = gt_classes.to(torch.int64)
        valid = valid.to(torch.bool)
        base_sim = self.likelihood(attention, feats, slots)
        sim_full = feats.new_full((n, n_total), -2.0 if self.is_matrix else 0.0)
        if self.is_matrix:  # the background's 0.5 at the gt slot
            sim_full[torch.arange(n, device=feats.device), gt] = 0.5
        sim_full = sim_full.index_copy(1, slot_ids, base_sim)

        gt_scores = sim_full.gather(1, gt[:, None])
        dist = gt_scores - sim_full
        is_gt = F.one_hot(gt, n_total).to(torch.bool)
        margin = torch.where(is_gt, dist, (0.5 - dist).clamp_min(0.0))[:, slot_ids]
        # both counts span the global batch (a collective under data parallelism)
        n_valid = global_normalizer(valid.to(torch.float32).sum())
        margin_loss = torch.where(valid[:, None], margin, 0.0).sum() / (n_valid * len(slots))
        reg = (1.0 - gt_scores[:, 0]).clamp_min(0.0)
        reg_valid = valid & (gt < self.num_classes) if self.is_matrix else valid
        reg_loss = torch.where(reg_valid, reg, 0.0).sum() / global_normalizer(
            reg_valid.to(torch.float32).sum())

        out = {"loss_rank_margin": margin_loss, "loss_rank_reg": reg_loss}
        if self.mode != "locatron":  # Locatron drops the prototype classification loss
            logp = torch.log_softmax(self.rank_loss_classifier(attention.mean[slot_ids]), dim=-1)
            out["loss_rank_cls"] = -logp.gather(1, slot_ids[:, None]).mean()
        return out
