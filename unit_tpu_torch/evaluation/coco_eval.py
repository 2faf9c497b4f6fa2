"""COCO detection and segmentation evaluation with novel-class slicing (the
port's copy of unit_tpu/evaluation/coco_eval.py: numpy only).

A self-contained COCOeval protocol: AP and AR over IoU 0.50:0.95, 101-point
interpolated precision, the four area ranges, maxDets 1/10/100, the standard
12-stat summary, and ``novel_mean`` = AP50 over the novel class ids.  Against
a crowd GT region the IoU's denominator is the detection's own area.

Masks are evaluated densely: each detection's [M, M] mask probabilities are
pasted into its box at the image's resolution (``data.transforms.resize_image``,
then > 0.5) and compared with the GT mask, which is rasterised from the
annotation's polygons in the image frame (or, for an annotation without
polygons, pasted from its GT-box-frame ``box_mask``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from ..data.coco import rasterize_polygons
from ..data.transforms import resize_image

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _box_iou_matrix(dets: np.ndarray, gts: np.ndarray,
                    iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """[D, G] IoU (COCO convention, no +1).  Against a crowd GT the
    denominator is the detection's area alone: a detection inside a crowd
    region has IoU 1 with it whatever the region's extent."""
    d, g = len(dets), len(gts)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    dets = np.asarray(dets, np.float64)
    gts = np.asarray(gts, np.float64)
    iw = np.clip(
        np.minimum(dets[:, None, 2], gts[None, :, 2])
        - np.maximum(dets[:, None, 0], gts[None, :, 0]), 0, None)
    ih = np.clip(
        np.minimum(dets[:, None, 3], gts[None, :, 3])
        - np.maximum(dets[:, None, 1], gts[None, :, 1]), 0, None)
    inter = iw * ih
    da = (np.clip(dets[:, 2] - dets[:, 0], 0, None)
          * np.clip(dets[:, 3] - dets[:, 1], 0, None))
    ga = (np.clip(gts[:, 2] - gts[:, 0], 0, None)
          * np.clip(gts[:, 3] - gts[:, 1], 0, None))
    union = da[:, None] + ga[None, :] - inter
    if iscrowd is not None and np.any(iscrowd):
        union = np.where(np.asarray(iscrowd, bool)[None, :], da[:, None], union)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _paste(mask: np.ndarray, box, h: int, w: int) -> np.ndarray:
    """An [M, M] mask in ``box``'s frame, resized bilinearly into the box's
    integer extent on an [h, w] canvas and thresholded at 0.5."""
    x1, y1, x2, y2 = box
    canvas = np.zeros((h, w), bool)
    xi1, yi1 = int(max(np.floor(x1), 0)), int(max(np.floor(y1), 0))
    xi2, yi2 = int(min(np.ceil(x2), w)), int(min(np.ceil(y2), h))
    if xi2 > xi1 and yi2 > yi1:
        patch = resize_image(mask[:, :, None].astype(np.float32), yi2 - yi1, xi2 - xi1)
        canvas[yi1:yi2, xi1:xi2] = patch[:, :, 0] > 0.5
    return canvas


def _image_lists():
    return defaultdict(list)


class COCOEvaluator:
    """Accumulates per-image detections and GT and computes COCO stats.

    iou_type: 'bbox' or 'segm'.  For 'segm', detections carry ``masks``
    ([D, M, M] probabilities in the box frame) and the GT records polygons
    (``segmentation``) or GT-box-frame ``box_mask``s.
    """

    def __init__(
        self,
        class_names: Sequence[str],
        novel_class_ids: Sequence[int] = (),
        iou_type: str = "bbox",
    ):
        self.class_names = list(class_names)
        self.novel_ids = sorted(novel_class_ids)
        self.iou_type = iou_type
        self.reset()

    def reset(self):
        # a module-level factory, not a lambda: the evaluator stays picklable
        self._gt = defaultdict(_image_lists)   # cls -> img -> list
        self._dt = defaultdict(_image_lists)
        self._images = set()

    # ------------------------------------------------------------- ingestion
    def process_gt_record(self, record: dict):
        img = record["image_id"]
        self._images.add(img)
        for ann in record.get("annotations", []):
            x1, y1, x2, y2 = ann["bbox"]
            mask = ann.get("mask")
            if self.iou_type == "segm" and mask is None:
                h, w = int(record["height"]), int(record["width"])
                if isinstance(ann.get("segmentation"), list):
                    # pixel-exact polygon rasterisation in the image frame
                    mask = rasterize_polygons(ann["segmentation"], h, w)
                elif ann.get("box_mask") is not None:
                    mask = _paste(ann["box_mask"], ann["bbox"], h, w)
            self._gt[ann["category_id"]][img].append({
                "bbox": np.asarray([x1, y1, x2, y2], np.float64),
                "area": ann.get("area", (x2 - x1) * (y2 - y1)),
                "iscrowd": ann.get("iscrowd", 0),
                "mask": mask,
            })

    def process(self, image_id, boxes, scores, classes, valid, masks=None):
        boxes = np.asarray(boxes)
        scores = np.asarray(scores)
        classes = np.asarray(classes)
        valid = np.asarray(valid)
        self._images.add(image_id)
        for i in range(len(boxes)):
            if not valid[i]:
                continue
            self._dt[int(classes[i])][image_id].append({
                "bbox": boxes[i].astype(np.float64),
                "score": float(scores[i]),
                "mask": None if masks is None else np.asarray(masks[i]),
            })

    def merge_from(self, other: "COCOEvaluator"):
        """Fold another evaluator's detections and GT in."""
        for cid, per_img in other._gt.items():
            for img, gts in per_img.items():
                self._gt[cid][img].extend(gts)
        for cid, per_img in other._dt.items():
            for img, dts in per_img.items():
                self._dt[cid][img].extend(dts)
        self._images |= other._images

    # ------------------------------------------------------------- matching
    def _mask_iou(self, det, gts) -> np.ndarray:
        """Dense IoU between one detection's pasted mask and the GT masks."""
        out = np.zeros(len(gts))
        if det.get("mask") is None:
            return out
        for j, gt in enumerate(gts):
            gm = gt.get("mask")
            if gm is None:
                continue
            canvas = _paste(det["mask"], det["bbox"], *gm.shape)
            inter = np.logical_and(canvas, gm).sum()
            union = np.logical_or(canvas, gm).sum()
            out[j] = inter / union if union > 0 else 0.0
        return out

    def _evaluate_img(self, cls, img, area_rng):
        gts = self._gt[cls].get(img, [])
        dts = sorted(self._dt[cls].get(img, []), key=lambda d: -d["score"])[: MAX_DETS[-1]]
        if not gts and not dts:
            return None
        # the closed interval [lo, hi], as pycocotools (an area of 32**2 is
        # both 'small' and 'medium' there)
        ignore_gt = np.asarray(
            [g["iscrowd"] or not (area_rng[0] <= g["area"] <= area_rng[1])
             for g in gts],
            bool,
        )
        order_gt = np.argsort(ignore_gt, kind="stable")  # the GT that counts first
        gts = [gts[i] for i in order_gt]
        ignore_gt = ignore_gt[order_gt]

        if self.iou_type == "bbox":
            iou = _box_iou_matrix(
                np.asarray([d["bbox"] for d in dts]).reshape(-1, 4),
                np.asarray([g["bbox"] for g in gts]).reshape(-1, 4),
                iscrowd=np.asarray([g["iscrowd"] for g in gts], bool),
            )
        else:
            iou = np.stack([self._mask_iou(d, gts) for d in dts]) if dts and gts else (
                np.zeros((len(dts), len(gts)))
            )

        t = len(IOU_THRS)
        d = len(dts)
        g = len(gts)
        dt_m = -np.ones((t, d), np.int64)
        gt_m = -np.ones((t, g), np.int64)
        dt_ig = np.zeros((t, d), bool)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(d):
                best, bj = min(thr, 1 - 1e-10), -1
                for gj in range(g):
                    if gt_m[ti, gj] >= 0 and not gts[gj]["iscrowd"]:
                        continue
                    if bj >= 0 and not ignore_gt[bj] and ignore_gt[gj]:
                        break  # matched, and into the ignored GT: stop
                    if iou[di, gj] < best:
                        continue
                    best, bj = iou[di, gj], gj
                if bj >= 0:
                    dt_m[ti, di] = bj
                    gt_m[ti, bj] = di
                    dt_ig[ti, di] = ignore_gt[bj]
        # unmatched detections outside the area range are ignored
        a = np.asarray(
            [
                (d_["bbox"][2] - d_["bbox"][0]) * (d_["bbox"][3] - d_["bbox"][1])
                for d_ in dts
            ]
        )
        out_of_rng = (a < area_rng[0]) | (a > area_rng[1])
        dt_ig = dt_ig | ((dt_m < 0) & out_of_rng[None, :])
        return {
            "scores": np.asarray([d_["score"] for d_ in dts]),
            "dt_matched": dt_m >= 0,
            "dt_ignore": dt_ig,
            "num_gt": int((~ignore_gt).sum()),
        }

    # ------------------------------------------------------------- accumulate
    def evaluate(self) -> dict:
        k = len(self.class_names)
        t = len(IOU_THRS)
        a = len(AREA_RNG)
        m = len(MAX_DETS)
        precision = -np.ones((t, len(REC_THRS), k, a, m))
        recall = -np.ones((t, k, a, m))

        for ki in range(k):
            for ai, (_, rng) in enumerate(AREA_RNG.items()):
                # a fixed image order: score ties concatenate as they do over
                # pycocotools' sorted imgIds
                evals = [
                    e
                    for img in sorted(self._images, key=str)
                    if (e := self._evaluate_img(ki, img, rng)) is not None
                ]
                if not evals:
                    continue
                npig = sum(e["num_gt"] for e in evals)
                if npig == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate([e["scores"][:max_det] for e in evals])
                    matched = np.concatenate(
                        [e["dt_matched"][:, :max_det] for e in evals], axis=1
                    )
                    ignored = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in evals], axis=1
                    )
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]
                    for ti in range(t):
                        keep = ~ignored[ti]
                        tp = np.cumsum(matched[ti][keep])
                        fp = np.cumsum(~matched[ti][keep])
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # the precision envelope, read at 101 recall points
                        for i in range(nd - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(len(REC_THRS))
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self.precision = precision
        self.recall = recall
        stats = self._summarize(None)
        res = {
            "AP": stats[0], "AP50": stats[1], "AP75": stats[2],
            "APs": stats[3], "APm": stats[4], "APl": stats[5],
            "AR1": stats[6], "AR10": stats[7], "AR100": stats[8],
            "ARs": stats[9], "ARm": stats[10], "ARl": stats[11],
        }
        if self.novel_ids:
            novel_stats = self._summarize(self.novel_ids)
            res["novel_mean"] = novel_stats[1]  # AP50 over the novel classes
            res["novel_AP"] = novel_stats[0]
        return {self.iou_type: res}

    def _summarize(self, class_ids: Optional[Sequence[int]]) -> np.ndarray:
        sel = slice(None) if class_ids is None else list(class_ids)

        def ap(iou_thr=None, area="all", max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            s = self.precision[:, :, sel, ai, mi]
            if iou_thr is not None:
                ti = int(np.argmin(np.abs(IOU_THRS - iou_thr)))
                s = s[ti: ti + 1]
            s = s[s > -1]
            return float(np.mean(s)) * 100 if s.size else -1.0

        def ar(area="all", max_det=100):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS.index(max_det)
            s = self.recall[:, sel, ai, mi]
            s = s[s > -1]
            return float(np.mean(s)) * 100 if s.size else -1.0

        return np.asarray([
            ap(), ap(0.5), ap(0.75), ap(area="small"), ap(area="medium"),
            ap(area="large"), ar(max_det=1), ar(max_det=10), ar(max_det=100),
            ar(area="small"), ar(area="medium"), ar(area="large"),
        ])
