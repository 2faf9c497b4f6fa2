"""Box predictors (weak detector streams, supervised delta heads) and the
base -> novel transfer.

Port of unit_tpu/models/predictors.py for the base-training, fine-tuning
and inference paths of the shipped configs.  The heads are f32 ``nn.Linear``
layers named after the flax parameters; the transfer math is plain functions
on tensors.  The fine-tune variants add zero-initialised heads (``*_ft`` on
the supervised branch, ``*_delta`` streams on the weak detector), which draw
nothing from the generator, so a base model's seeded weights are the same
with or without them.  The weak detector's regression branches
(WEAK_DETECTOR.REGRESSION_BRANCH: ``regression_branch_cls``/``_bbox``, which
then score at inference; OICR_REGRESSION_BRANCH: one ``oicr_regressor_k``
a refinement head, averaged into the inference deltas) and OICR_ITER 0 (the
MIL classifier stream scores at inference) are set by no shipped config.
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

    ``forward`` gives the training streams (raw logits; the losses are in
    models/weak_losses.py), ``evaluation`` the inference scores: the
    regression branch's where there is one, else the OICR heads', else (OICR
    iterations 0) the MIL classifier stream's.  With ``finetune``
    (WeakDetectorOutputsFT) every stream is its base head with the
    ``novel_ids`` columns zeroed plus a zero-initialised ``*_delta`` head
    (unit_tpu predictors.py:77-108).
    """

    def __init__(self, in_features: int, num_classes: int, oicr_iter: int = 3,
                 detector_temp: float = 1.0, classifier_temp: float = 1.0,
                 box_dim: int = 4, finetune: bool = False, novel_ids: Sequence[int] = (),
                 regression_branch: bool = False, oicr_regression_branch: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = num_classes
        self.num_classes, self.box_dim, self.oicr_iter = c, box_dim, oicr_iter
        self.detector_temp, self.classifier_temp = detector_temp, classifier_temp
        self.finetune, self.novel_ids = finetune, tuple(novel_ids)
        self.regression_branch = regression_branch
        self.oicr_regression_branch = oicr_regression_branch
        self.classifier_stream = _dense(in_features, c, 0.01, generator)
        self.detection_stream = _dense(in_features, c, 0.01, generator)
        for i in range(oicr_iter):
            self.add_module(f"oicr_predictor_{i}",
                            _dense(in_features, c + 1, 0.01, generator))
        if oicr_regression_branch:
            for i in range(oicr_iter):
                self.add_module(f"oicr_regressor_{i}",
                                _dense(in_features, c * box_dim, 0.001, generator))
        if regression_branch:
            self.regression_branch_cls = _dense(in_features, c + 1, 0.01, generator)
            self.regression_branch_bbox = _dense(in_features, c * box_dim, 0.001, generator)
        if finetune:
            self.classifier_stream_delta = _dense(in_features, c, None, generator)
            self.detection_stream_delta = _dense(in_features, c, None, generator)
            for i in range(oicr_iter):
                self.add_module(f"oicr_predictor_delta_{i}",
                                _dense(in_features, c + 1, None, generator))

    def oicr_predictors(self) -> List[nn.Linear]:
        return [getattr(self, f"oicr_predictor_{i}") for i in range(self.oicr_iter)]

    def _mask_novel(self, x: torch.Tensor) -> torch.Tensor:
        """x with its novel-class columns multiplied by zero (unit_tpu's mask)."""
        if not self.novel_ids:
            return x
        mask = torch.ones(x.shape[-1], device=x.device)
        mask[list(self.novel_ids)] = 0.0
        return x * mask

    def _oicr_logits(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, m in enumerate(self.oicr_predictors()):
            o = m(x)
            if self.finetune:
                o = self._mask_novel(o) + getattr(self, f"oicr_predictor_delta_{i}")(x)
            outs.append(o)
        return outs

    def oicr_regressors(self) -> List[nn.Linear]:
        if not self.oicr_regression_branch:
            return []
        return [getattr(self, f"oicr_regressor_{i}") for i in range(self.oicr_iter)]

    def forward(self, x: torch.Tensor) -> Dict[str, object]:
        """Training streams: MIL classifier and detection logits divided by
        their temperatures [N, C], the OICR logits [N, C+1] per iteration, the
        OICR regressors' deltas [N, C*4] per iteration (``oicr_bbox``, empty
        without them) and, with the regression branch, its logits and deltas
        (``regression_cls``, ``regression_bbox``)."""
        cls = self.classifier_stream(x) / self.classifier_temp
        det = self.detection_stream(x) / self.detector_temp
        if self.finetune:
            cls = self.classifier_stream_delta(x) / self.classifier_temp + self._mask_novel(cls)
            det = self.detection_stream_delta(x) / self.detector_temp + self._mask_novel(det)
        out = {"classifier_stream": cls, "detection_stream": det,
               "oicr_scores": self._oicr_logits(x),
               "oicr_bbox": [r(x) for r in self.oicr_regressors()]}
        if self.regression_branch:
            out["regression_cls"] = self.regression_branch_cls(x)
            out["regression_bbox"] = self.regression_branch_bbox(x)
        return out

    def evaluation(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inference-time weak scores and bbox deltas [N, C*4]: the regression
        branch's ([1, N, C+1] and its deltas); else the OICR logits stacked
        over iterations [K, N, C+1] and the mean of the OICR regressors'
        deltas (zero without them); else, OICR iterations 0, the classifier
        stream over its temperature [1, N, C] and zero deltas."""
        zeros = x.new_zeros((x.shape[0], self.num_classes * self.box_dim))
        if self.regression_branch:
            return self.regression_branch_cls(x)[None], self.regression_branch_bbox(x)
        if self.oicr_iter > 0:
            regressors = self.oicr_regressors()
            bbox = (torch.stack([r(x) for r in regressors]).mean(0) if regressors else zeros)
            return torch.stack(self._oicr_logits(x)), bbox
        return (self.classifier_stream(x) / self.classifier_temp)[None], zeros


class SupervisedPredictor(nn.Module):
    """Zero-initialised delta heads of the supervised branch (the bbox delta
    normal(0.001), or zero where the weak regression branch gives the base
    regressor); with ``finetune`` (SupervisedDetectorOutputsFineTune) also
    the zero-initialised ``cls_score_ft`` / ``bbox_pred_ft`` residuals, whose
    outputs the model adds after the transfer."""

    def __init__(self, in_features: int, num_classes: int, box_dim: int = 4,
                 finetune: bool = False, regression_branch: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = num_classes
        self.finetune = finetune
        self.cls_score_delta = _dense(in_features, c + 1, None, generator)
        self.bbox_pred_delta = _dense(in_features, c * box_dim,
                                      None if regression_branch else 0.001, generator)
        if finetune:
            self.cls_score_ft = _dense(in_features, c + 1, None, generator)
            self.bbox_pred_ft = _dense(in_features, c * box_dim, None, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {
            "delta_scores": self.cls_score_delta(x),
            "proposal_deltas": self.bbox_pred_delta(x),
        }
        if self.finetune:
            out["ft_scores"] = self.cls_score_ft(x)
            out["ft_deltas"] = self.bbox_pred_ft(x)
        return out


def _ids(ids: Sequence[int], device) -> torch.Tensor:
    return torch.as_tensor(list(ids), dtype=torch.int64, device=device)


def transfer_scores(
    delta_scores: torch.Tensor,    # [N, C+1]
    similarity_cls: torch.Tensor,  # [V, B] or [N, V, B]
    base_ids: Sequence[int],
    novel_ids: Sequence[int],
    detach: bool = False,
) -> torch.Tensor:
    """Novel score columns get the similarity-weighted base columns added;
    ``detach`` stops the gradient of that term (WeakFineTune)."""
    base = delta_scores[:, _ids(base_ids, delta_scores.device)]
    if similarity_cls.dim() > 2:
        tr = torch.einsum("nvb,nb->nv", similarity_cls, base)
    else:
        tr = base @ similarity_cls.T
    if detach:
        tr = tr.detach()
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
    detach: bool = False,
) -> torch.Tensor:
    """Novel box deltas are replaced by the similarity combination of base
    deltas; base deltas are kept; every other class gets zeros.  ``detach``
    stops the gradient of the combination (WeakFineTune)."""
    n = proposal_deltas.shape[0]
    d4 = proposal_deltas.reshape(n, num_classes, box_dim)
    base_idx = _ids(base_ids, d4.device)
    base = d4[:, base_idx]
    if similarity_bbox.dim() > 2:
        tr = torch.einsum("nvb,nbd->nvd", similarity_bbox, base)
    else:
        tr = torch.einsum("vb,nbd->nvd", similarity_bbox, base)
    if detach:
        tr = tr.detach()
    out = torch.zeros_like(d4)
    out[:, _ids(novel_ids, d4.device)] = tr
    out[:, base_idx] = base
    return out.reshape(n, num_classes * box_dim)


def combine_cls_logits(delta_scores: torch.Tensor, weak_scores: torch.Tensor) -> torch.Tensor:
    """delta_scores [N, C+1] plus the OICR-iteration mean of the weak logits
    [K, N, C+1]; a weak head without a background column ([K, N, C], OICR
    iterations 0) is padded with zeros."""
    mean_weak = weak_scores.mean(dim=0)
    if mean_weak.shape[-1] == delta_scores.shape[-1] - 1:
        mean_weak = torch.nn.functional.pad(mean_weak, (0, 1))
    return delta_scores + mean_weak
