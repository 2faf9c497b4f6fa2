"""PASCAL VOC detection evaluation with novel-class slicing (the port's copy
of unit_tpu/evaluation/voc_eval.py: numpy only).

Rebuild of PascalVOCDetectionWeakEvaluator
(the reference repo's data/evaluators.py:104-244) and its vendored ``voc_eval``/``voc_ap``
(:342-508): AP per class over IoU 0.50:0.95, reporting AP / AP50 / AP75 and
``novel_mean`` (mean AP50 over the novel classes).  Works directly on in-memory
GT records instead of re-parsing XML per class per threshold, and evaluates all
IoU thresholds in one matching pass per class — same results, far less host time
than the reference's mp.Pool(10) XML fan-out.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """AP given precision/recall. 11-point metric for VOC2007, else area-under-PR."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_class(
    dets: List[tuple],           # [(image_id, score, x1, y1, x2, y2)]
    gt_by_image: Dict[str, dict],  # image_id -> {"boxes": [n,4], "difficult": [n]}
    iou_thresholds: Sequence[float],
    use_07_metric: bool,
) -> List[float]:
    """APs of one class at each IoU threshold (one sort + one IoU pass)."""
    npos = sum(int((~g["difficult"]).sum()) for g in gt_by_image.values())
    if not dets:
        return [0.0 for _ in iou_thresholds]

    dets = sorted(dets, key=lambda d: -d[1])
    ious = np.zeros(len(dets))
    gt_idx = np.full(len(dets), -1, np.int64)
    for i, (img_id, _, x1, y1, x2, y2) in enumerate(dets):
        g = gt_by_image.get(img_id)
        if g is None or len(g["boxes"]) == 0:
            continue
        gb = g["boxes"]
        ixmin = np.maximum(gb[:, 0], x1)
        iymin = np.maximum(gb[:, 1], y1)
        ixmax = np.minimum(gb[:, 2], x2)
        iymax = np.minimum(gb[:, 3], y2)
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inters = iw * ih
        uni = (
            (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
            + (gb[:, 2] - gb[:, 0] + 1.0) * (gb[:, 3] - gb[:, 1] + 1.0)
            - inters
        )
        overlaps = inters / np.maximum(uni, 1e-9)
        j = int(np.argmax(overlaps))
        ious[i] = overlaps[j]
        gt_idx[i] = j

    aps = []
    for thr in iou_thresholds:
        claimed = {k: np.zeros(len(g["boxes"]), bool) for k, g in gt_by_image.items()}
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (img_id, *_rest) in enumerate(dets):
            g = gt_by_image.get(img_id)
            if g is None or ious[i] <= thr or gt_idx[i] < 0:
                fp[i] = 1.0
                continue
            j = gt_idx[i]
            if g["difficult"][j]:
                continue  # neither tp nor fp (reference voc_eval difficult handling)
            if not claimed[img_id][j]:
                claimed[img_id][j] = True
                tp[i] = 1.0
            else:
                fp[i] = 1.0
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / max(npos, 1)
        prec = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
        aps.append(voc_ap(rec, prec, use_07_metric))
    return aps


class PascalVOCEvaluator:
    """Accumulates padded Detections + GT records and computes the metric dict
    {"bbox": {"AP", "AP50", "AP75", "novel_mean"}} (evaluators.py:204-218)."""

    def __init__(
        self,
        class_names: Sequence[str],
        novel_class_ids: Sequence[int] = (),
        use_07_metric: bool = True,
        iou_thresholds: Sequence[float] = tuple(t / 100.0 for t in range(50, 100, 5)),
    ):
        self.class_names = list(class_names)
        self.novel_ids = set(novel_class_ids)
        self.use_07 = use_07_metric
        self.thresholds = list(iou_thresholds)
        self.reset()

    def reset(self):
        self._dets = defaultdict(list)  # class_id -> [(image_id, score, box...)]
        self._gt = defaultdict(dict)    # class_id -> image_id -> {boxes, difficult}

    def process_gt_record(self, record: dict):
        """Register GT from a dataset record dict (with 'annotations')."""
        per_class = defaultdict(list)
        for ann in record.get("annotations", []):
            per_class[ann["category_id"]].append(
                (ann["bbox"], ann.get("difficult", 0))
            )
        for cid in range(len(self.class_names)):
            items = per_class.get(cid, [])
            self._gt[cid][record["image_id"]] = {
                "boxes": np.asarray([b for b, _ in items], np.float64).reshape(-1, 4),
                "difficult": np.asarray([d for _, d in items], bool),
            }

    def process(self, image_id: str, boxes, scores, classes, valid, masks=None):
        """Register one image's padded detections (original-image coordinates)."""
        boxes = np.asarray(boxes)
        scores = np.asarray(scores)
        classes = np.asarray(classes)
        valid = np.asarray(valid)
        for box, score, cls, ok in zip(boxes, scores, classes, valid):
            if not ok:
                continue
            self._dets[int(cls)].append(
                (image_id, float(score), box[0], box[1], box[2], box[3])
            )

    def merge_from(self, other: "PascalVOCEvaluator"):
        """Fold another host's accumulated detections/GT in (multi-host eval:
        each host runs its loader shard; reference gathers per-rank results,
        data/evaluators.py:159-166)."""
        for cid, dets in other._dets.items():
            self._dets[cid].extend(dets)
        for cid, per_img in other._gt.items():
            self._gt[cid].update(per_img)

    def evaluate(self) -> dict:
        aps = defaultdict(list)  # threshold -> per-class AP
        for cid in range(len(self.class_names)):
            class_aps = eval_class(
                self._dets.get(cid, []), self._gt.get(cid, {}),
                self.thresholds, self.use_07,
            )
            for thr, ap in zip(self.thresholds, class_aps):
                aps[thr].append(ap * 100.0)

        ap50 = aps[0.5]
        novel = [ap for cid, ap in enumerate(ap50) if cid in self.novel_ids]
        m = {thr: float(np.mean(v)) for thr, v in aps.items()}
        return {
            "bbox": {
                "AP": float(np.mean(list(m.values()))),
                "AP50": m[0.5],
                "AP75": m[0.75],
                "novel_mean": float(np.mean(novel)) if novel else None,
                "class_AP50": dict(zip(self.class_names, ap50)),
            }
        }
