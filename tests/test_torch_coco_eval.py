"""COCOEvaluator: unit_tpu_torch vs unit_tpu, and the frozen fixture.

The same seeded GT and detections go through both evaluators: crowd regions,
objects in every area range, novel class ids, GT masks as polygons and as
GT-box-frame bitmasks, detection masks as [28, 28] probabilities.  The two
are the same float64 numpy code, so every stat agrees to 1e-12.
tests/fixtures/coco_eval_fixture.json (GT and detections in COCO json, the
12 stats unit_tpu computed) replays to its recorded stats within 1e-9, as
tests/test_coco_eval_fixture.py holds unit_tpu's evaluator.
"""

import json
import os
import pickle

import numpy as np
import pytest

from unit_tpu.evaluation.coco_eval import COCOEvaluator as JCOCOEvaluator
from unit_tpu_torch.evaluation.coco_eval import COCOEvaluator

STAT_TOL = 1e-12
FIXTURE_TOL = 1e-9
C = 8
NOVEL = (1, 4, 6)
STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl",
         "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "coco_eval_fixture.json")


def polygon(rng, x1, y1, x2, y2):
    """A convex-ish polygon of 5-9 vertices inside the box."""
    k = rng.randint(5, 10)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
    r = rng.uniform(0.6, 1.0, k)
    return [float(v) for a, s in zip(ang, r)
            for v in (cx + s * rx * np.cos(a), cy + s * ry * np.sin(a))]


def make_case(seed, n_images=6):
    """(GT records, detections per image) from ``seed``."""
    rng = np.random.RandomState(seed)
    records, dets = [], []
    for i in range(n_images):
        h, w = rng.randint(120, 320, 2)
        anns = []
        for _ in range(rng.randint(0, 7)):
            side = rng.choice([12.0, 50.0, 140.0]) * rng.uniform(0.7, 1.3)  # all area ranges
            bw, bh = min(side, w - 2), min(side * rng.uniform(0.6, 1.4), h - 2)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            box = [x1, y1, x1 + bw, y1 + bh]
            ann = {"category_id": int(rng.randint(C)), "bbox": box,
                   "area": float(bw * bh * rng.uniform(0.5, 1.0)),
                   "iscrowd": int(rng.rand() < 0.15)}
            if rng.rand() < 0.7:
                ann["segmentation"] = [polygon(rng, *box)]
            else:
                m = np.zeros((28, 28), np.float32)
                m[4:24, rng.randint(0, 8):rng.randint(18, 28)] = 1.0
                ann["box_mask"] = m
            anns.append(ann)
        records.append({"image_id": f"img{i}", "height": int(h), "width": int(w),
                        "annotations": anns})
        d = rng.randint(0, 12)
        boxes = np.zeros((d, 4))
        classes = rng.randint(C, size=d)
        for j in range(d):
            if anns and rng.rand() < 0.7:  # near a GT box, sometimes of its class
                a = anns[rng.randint(len(anns))]
                b = np.asarray(a["bbox"]) + rng.normal(0, 4, 4)
                if rng.rand() < 0.6:
                    classes[j] = a["category_id"]
            else:
                x1, y1 = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
                b = np.asarray([x1, y1, x1 + rng.uniform(5, 120), y1 + rng.uniform(5, 120)])
            boxes[j] = b
        scores = np.round(rng.rand(d), 2)  # ties among the scores
        valid = rng.rand(d) < 0.9
        yy, xx = np.mgrid[:28, :28] / 28.0
        masks = np.asarray([np.clip(1.2 - 1.8 * np.hypot(yy - rng.uniform(0.4, 0.6),
                                                         xx - rng.uniform(0.4, 0.6))
                                    + rng.normal(0, 0.1, (28, 28)), 0, 1)
                            for _ in range(d)], np.float32).reshape(d, 28, 28)
        dets.append((f"img{i}", boxes, scores, classes, valid, masks))
    return records, dets


def evaluate(cls, iou_type, records, dets, split=False):
    names = [f"c{k}" for k in range(C)]
    evs = [cls(names, novel_class_ids=NOVEL, iou_type=iou_type) for _ in range(2 if split else 1)]
    for k, rec in enumerate(records):
        evs[k % len(evs)].process_gt_record(rec)
    for k, (img, boxes, scores, classes, valid, masks) in enumerate(dets):
        evs[k % len(evs)].process(img, boxes, scores, classes, valid,
                                  masks=masks if iou_type == "segm" else None)
    ev = evs[0]
    for other in evs[1:]:
        ev.merge_from(pickle.loads(pickle.dumps(other)))
    return ev.evaluate()[iou_type]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_stats_match_unit_tpu(iou_type, seed):
    records, dets = make_case(seed)
    want = evaluate(JCOCOEvaluator, iou_type, records, dets)
    got = evaluate(COCOEvaluator, iou_type, records, dets)
    assert set(got) == set(want) == set(STATS) | {"novel_mean", "novel_AP"}
    for k in want:
        assert abs(got[k] - want[k]) <= STAT_TOL, (k, got[k], want[k])
    assert got["AP50"] > 0 and got["novel_mean"] > 0  # detections matched


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_pickled_and_merged_halves_give_the_same_stats(iou_type):
    records, dets = make_case(3)
    whole = evaluate(COCOEvaluator, iou_type, records, dets)
    assert evaluate(COCOEvaluator, iou_type, records, dets, split=True) == whole


def test_fixture_replays_to_its_recorded_stats():
    fx = json.load(open(FIXTURE))
    gt = fx["gt"]
    n_cls = len(gt["categories"])
    ev = COCOEvaluator([f"class_{i}" for i in range(1, n_cls + 1)])
    for img in gt["images"]:
        ev.process_gt_record({
            "image_id": img["id"], "height": img["height"], "width": img["width"],
            "annotations": [{"bbox": [a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                                      a["bbox"][1] + a["bbox"][3]],
                             "category_id": a["category_id"] - 1, "area": a["area"],
                             "iscrowd": a["iscrowd"]}
                            for a in gt["annotations"] if a["image_id"] == img["id"]]})
    by_img = {}
    for d in fx["detections"]:
        by_img.setdefault(d["image_id"], []).append(d)
    for img, ds in by_img.items():
        boxes = np.asarray([[d["bbox"][0], d["bbox"][1], d["bbox"][0] + d["bbox"][2],
                             d["bbox"][1] + d["bbox"][3]] for d in ds], np.float64)
        ev.process(img, boxes, np.asarray([d["score"] for d in ds]),
                   np.asarray([d["category_id"] - 1 for d in ds]), np.ones(len(ds), bool))
    res = ev.evaluate()["bbox"]
    assert list(fx["stat_names"]) == list(STATS)
    np.testing.assert_allclose([res[k] for k in STATS], fx["expected_stats"], atol=FIXTURE_TOL)
