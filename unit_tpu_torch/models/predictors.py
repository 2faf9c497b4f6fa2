"""Box predictors (weak detector streams, supervised delta heads) and the
base -> novel transfer.

Port of unit_tpu/models/predictors.py for the inference path of the shipped
configs.  The heads are f32 ``nn.Linear`` layers named after the flax
parameters; the transfer math is plain functions on tensors.  The fine-tune
(``*_ft`` / delta stream) variants belong to ROADMAP Queue 1 item 19, the
weak regression branches (set by no shipped config) to item 25.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


def _dense(in_features: int, out_features: int, std: Optional[float],
           generator: Optional[torch.Generator]) -> nn.Linear:
    """Linear with flax/d2 init: normal(std) weight (zeros if std is None),
    zero bias."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features)
    with torch.no_grad():
        if std is None:
            lin.weight.zero_()
        else:
            lin.weight.normal_(0.0, std, generator=generator)
        lin.bias.zero_()
    return lin


class WeakDetectorPredictor(nn.Module):
    """MIL + OICR linear heads over box features [N, D].

    The MIL streams are not read at inference; they are here so a flax
    parameter tree loads strictly.
    """

    def __init__(self, in_features: int, num_classes: int, oicr_iter: int = 3,
                 box_dim: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = num_classes
        self.num_classes, self.box_dim, self.oicr_iter = c, box_dim, oicr_iter
        self.classifier_stream = _dense(in_features, c, 0.01, generator)
        self.detection_stream = _dense(in_features, c, 0.01, generator)
        for i in range(oicr_iter):
            self.add_module(f"oicr_predictor_{i}",
                            _dense(in_features, c + 1, 0.01, generator))

    def oicr_predictors(self) -> List[nn.Linear]:
        return [getattr(self, f"oicr_predictor_{i}") for i in range(self.oicr_iter)]

    def evaluation(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inference-time weak scores: (OICR logits stacked over iterations
        [K, N, C+1], bbox deltas [N, C*4], zero without a regression branch)."""
        cls = torch.stack([m(x) for m in self.oicr_predictors()])
        return cls, x.new_zeros((x.shape[0], self.num_classes * self.box_dim))


class SupervisedPredictor(nn.Module):
    """Zero-initialised delta heads of the supervised branch."""

    def __init__(self, in_features: int, num_classes: int, box_dim: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = num_classes
        self.cls_score_delta = _dense(in_features, c + 1, None, generator)
        self.bbox_pred_delta = _dense(in_features, c * box_dim, 0.001, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {
            "delta_scores": self.cls_score_delta(x),
            "proposal_deltas": self.bbox_pred_delta(x),
        }


def _ids(ids: Sequence[int], device) -> torch.Tensor:
    return torch.as_tensor(list(ids), dtype=torch.int64, device=device)


def transfer_scores(
    delta_scores: torch.Tensor,    # [N, C+1]
    similarity_cls: torch.Tensor,  # [V, B] or [N, V, B]
    base_ids: Sequence[int],
    novel_ids: Sequence[int],
) -> torch.Tensor:
    """Novel score columns get the similarity-weighted base columns added."""
    base = delta_scores[:, _ids(base_ids, delta_scores.device)]
    if similarity_cls.dim() > 2:
        tr = torch.einsum("nvb,nb->nv", similarity_cls, base)
    else:
        tr = base @ similarity_cls.T
    out = delta_scores.clone()
    out[:, _ids(novel_ids, delta_scores.device)] += tr
    return out


def transfer_deltas(
    proposal_deltas: torch.Tensor,  # [N, C*4]
    similarity_bbox: torch.Tensor,  # [V, B] or [N, V, B]
    base_ids: Sequence[int],
    novel_ids: Sequence[int],
    num_classes: int,
    box_dim: int = 4,
) -> torch.Tensor:
    """Novel box deltas are replaced by the similarity combination of base
    deltas; base deltas are kept; every other class gets zeros."""
    n = proposal_deltas.shape[0]
    d4 = proposal_deltas.reshape(n, num_classes, box_dim)
    base_idx = _ids(base_ids, d4.device)
    base = d4[:, base_idx]
    if similarity_bbox.dim() > 2:
        tr = torch.einsum("nvb,nbd->nvd", similarity_bbox, base)
    else:
        tr = torch.einsum("vb,nbd->nvd", similarity_bbox, base)
    out = torch.zeros_like(d4)
    out[:, _ids(novel_ids, d4.device)] = tr
    out[:, base_idx] = base
    return out.reshape(n, num_classes * box_dim)


def combine_cls_logits(delta_scores: torch.Tensor, weak_scores: torch.Tensor) -> torch.Tensor:
    """delta_scores [N, C+1] plus the OICR-iteration mean of the weak logits
    [K, N, C+1]."""
    return delta_scores + weak_scores.mean(dim=0)
