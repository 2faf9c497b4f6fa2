"""Base -> novel similarity matrices (lingual, visual and weight-space terms).

Port of unit_tpu/models/similarity.py.  Terms per head type ('cls', 'bbox',
'seg'):
  'lingual'   GloVe class-name embedding dot products, softmax-normalised
  'visual'    weak-detector posteriors of the ROI over base classes,
              renormalised and thresholded
  'TopK-k' / 'WTopK-k' / 'LSDA-k'  OICR classifier weight-space similarity
  'VisualK-k' per-ROI top-k of the visual posteriors
  'Average'   uniform transfer
  'None'      zero matrix (no transfer)
combined by 'Sum' (weighted mean, then row-normalised) or elementwise product.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# The 80 COCO category names in model order: rows of the GloVe table.
COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck",
    "boat", "traffic light", "fire hydrant", "stop sign", "parking meter", "bench",
    "bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra",
    "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "wine glass", "cup",
    "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

# VOC -> COCO synonym remaps.
_VOC_TO_COCO_NAME = {
    "aeroplane": "airplane",
    "diningtable": "dining table",
    "motorbike": "motorcycle",
    "pottedplant": "potted plant",
    "sofa": "couch",
    "tvmonitor": "tv",
}

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat", "chair",
    "cow", "diningtable", "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
]


def coco_indexer_for(class_names: Sequence[str]) -> np.ndarray:
    """Map dataset class names to rows of the 80-class GloVe table."""
    lut = {n: i for i, n in enumerate(COCO_CLASSES)}
    return np.asarray(
        [lut[_VOC_TO_COCO_NAME.get(n, n)] for n in class_names], dtype=np.int32
    )


class SimilarityConfig(NamedTuple):
    terms: Tuple[Tuple[str, Tuple[str, ...]], ...]  # ((head_type, term-names), ...)
    base_ids: Tuple[int, ...]
    novel_ids: Tuple[int, ...]
    coco_indexer: Tuple[int, ...]
    combination: str = "Sum"
    visual_threshold: float = 0.02

    @classmethod
    def from_cfg(cls, cfg, class_names: Sequence[str]) -> "SimilarityConfig":
        terms = [
            ("cls", tuple(cfg.MODEL.ROI_HEADS.FINETUNE_TERMS.CLASSIFIER)),
            ("bbox", tuple(cfg.MODEL.ROI_HEADS.FINETUNE_TERMS.BBOX)),
        ]
        if cfg.MODEL.MASK_ON:
            terms.append(("seg", tuple(cfg.MODEL.ROI_HEADS.FINETUNE_TERMS.MASK)))
        return cls(
            terms=tuple(terms),
            base_ids=tuple(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID),
            novel_ids=tuple(cfg.DATASETS.FEWSHOT.NOVEL_CLASSES_ID),
            coco_indexer=tuple(int(i) for i in coco_indexer_for(class_names)),
            combination=cfg.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.SIMILARITY_COMBINATION,
            visual_threshold=cfg.MODEL.ROI_HEADS.VISUAL_ATTENTION_HEAD.VISUAL_SIMILARITY_THRESHOLD,
        )


def _idx(ids, device) -> torch.Tensor:
    return torch.as_tensor(list(ids), dtype=torch.int64, device=device)


def lingual_similarity(embeddings: torch.Tensor, scfg: SimilarityConfig) -> torch.Tensor:
    """[V, B] novel-to-base GloVe dot products."""
    emb = embeddings[_idx(scfg.coco_indexer, embeddings.device)]
    base = emb[_idx(scfg.base_ids, emb.device)]
    novel = emb[_idx(scfg.novel_ids, emb.device)]
    return novel @ base.T


def visual_similarity(weak_eval_scores: torch.Tensor, scfg: SimilarityConfig) -> torch.Tensor:
    """[N, B] per-ROI base-class posterior similarity; weak_eval_scores is the
    [K, N, C+1] stack of OICR logits."""
    probs = weak_eval_scores.mean(dim=0)
    sim = torch.softmax(probs, dim=-1)[:, _idx(scfg.base_ids, probs.device)]
    sim = sim / sim.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return torch.where(sim < scfg.visual_threshold, 0.0, sim)


def _weight_space_matrix(oicr_weight_mean: torch.Tensor, scfg: SimilarityConfig,
                         kind: str, k: int) -> torch.Tensor:
    """TopK / WTopK / LSDA weight-space transfer matrices [V, B]."""
    dev = oicr_weight_mean.device
    base_w = oicr_weight_mean[_idx(scfg.base_ids, dev)]
    novel_w = oicr_weight_mean[_idx(scfg.novel_ids, dev)]
    if kind == "LSDA":
        d = torch.linalg.norm(novel_w[:, None, :] - base_w[None, :, :], dim=-1)
        _, idx = torch.topk(-d, k)
        vals = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    else:
        top, idx = torch.topk(novel_w @ base_w.T, k)
        vals = torch.ones_like(top) if kind == "TopK" else top
    out = torch.zeros((len(scfg.novel_ids), len(scfg.base_ids)), device=dev)
    out.scatter_(1, idx, vals)
    return out / out.sum(dim=-1, keepdim=True)


def similarity_matrices(
    scfg: SimilarityConfig,
    embeddings: Optional[torch.Tensor] = None,
    weak_eval_scores: Optional[torch.Tensor] = None,
    oicr_weight_mean: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-head-type transfer matrices: [V, B], or [N, V, B] when a per-ROI
    term is present."""
    v, b = len(scfg.novel_ids), len(scfg.base_ids)
    dev = next(t.device for t in (embeddings, weak_eval_scores, oicr_weight_mean)
               if t is not None)
    all_terms = {t for _, ts in scfg.terms for t in ts}
    ling = lingual_similarity(embeddings, scfg) if "lingual" in all_terms else None
    vis = None
    if "visual" in all_terms or any(t.startswith("VisualK") for t in all_terms):
        vis = visual_similarity(weak_eval_scores, scfg)

    out = {}
    for head_type, terms in scfg.terms:
        sim = torch.zeros((v, b), device=dev)
        if scfg.combination == "Sum":
            weight = 1.0 / max(len(terms), 1)
            if "lingual" in terms:
                sim = sim + weight * torch.softmax(ling, dim=-1)
            for kind in ("TopK", "WTopK", "LSDA"):
                match = [t for t in terms if t.startswith(kind + "-")]
                if match:
                    k = int(match[0].split("-")[1])
                    sim = sim + weight * _weight_space_matrix(oicr_weight_mean, scfg, kind, k)
            vk = [t for t in terms if t.startswith("VisualK-")]
            if vk:
                k = int(vk[0].split("-")[1])
                top, idx = torch.topk(vis, k)
                per_roi = torch.zeros_like(vis).scatter_(1, idx, top)
                per_roi = per_roi / per_roi.sum(-1, keepdim=True).clamp_min(1e-9)
                sim = sim[None] + weight * per_roi[:, None, :]
            if "visual" in terms:
                sim = (sim[None] if sim.dim() == 2 else sim) + weight * vis[:, None, :]
            if "Average" in terms:
                sim = torch.ones((v, b), device=dev)
                sim = sim / sim.sum(-1, keepdim=True)
            if len(terms) > 0 and "None" not in terms:
                sim = sim / sim.sum(dim=-1, keepdim=True).clamp_min(1e-9)
            else:
                sim = 0.0 * sim
        else:  # product combination
            sim = torch.ones((v, b), device=dev)
            if "lingual" in terms:
                sim = sim * ling
            if "visual" in terms:
                sim = sim[None] * vis[:, None, :]
            if len(terms) > 0:
                sim = torch.softmax(sim, dim=-1)
        out[head_type] = sim
    return out
