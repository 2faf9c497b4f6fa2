"""The PASCAL VOC evaluator of unit_tpu_torch vs unit_tpu's: exact equality.

Both are numpy; the same seeded detections and ground truth (difficult boxes,
duplicates, images without detections, empty classes) must give the same AP
per class and threshold, bit for bit.
"""

import numpy as np
import pytest

from unit_tpu.evaluation import voc_eval as jve
from unit_tpu_torch.evaluation import voc_eval as tve

NAMES = [f"class{i}" for i in range(6)]


def seeded_case(seed, n_images=12, n_classes=6):
    rng = np.random.RandomState(seed)
    records, dets = [], []
    for i in range(n_images):
        anns = []
        for _ in range(rng.randint(0, 5)):
            x1, y1 = rng.uniform(0, 200, 2)
            anns.append({"bbox": [x1, y1, x1 + rng.uniform(20, 120), y1 + rng.uniform(20, 120)],
                         "category_id": int(rng.randint(n_classes - 1)),  # last class: no GT
                         "difficult": int(rng.rand() < 0.2)})
        records.append({"image_id": f"img{i}", "annotations": anns})
        d = 16
        boxes = np.zeros((d, 4), np.float32)
        for k in range(d):
            if anns and rng.rand() < 0.6:  # near a ground-truth box, sometimes twice
                boxes[k] = np.asarray(anns[rng.randint(len(anns))]["bbox"]) + rng.randn(4) * 6
            else:
                x1, y1 = rng.uniform(0, 250, 2)
                boxes[k] = [x1, y1, x1 + rng.uniform(5, 150), y1 + rng.uniform(5, 150)]
        scores = rng.rand(d).astype(np.float32)
        scores[::5] = scores[0]  # tied scores
        classes = rng.randint(n_classes, size=d).astype(np.int32)
        valid = rng.rand(d) < 0.8
        if i == 3:
            valid[:] = False  # an image without detections
        dets.append((f"img{i}", boxes, scores, classes, valid))
    return records, dets


@pytest.mark.parametrize("use_07", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_equals_unit_tpu(seed, use_07):
    records, dets = seeded_case(seed)
    results = []
    for mod in (tve, jve):
        ev = mod.PascalVOCEvaluator(NAMES, novel_class_ids=(1, 4), use_07_metric=use_07)
        for rec in records:
            ev.process_gt_record(rec)
        for det in dets:
            ev.process(*det)
        results.append(ev.evaluate())
    got, want = results
    assert got == want  # every float identical, class_AP50 and novel_mean included
    assert 0 < got["bbox"]["AP50"] < 100


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_equals_unit_tpu(use_07):
    rng = np.random.RandomState(5)
    for _ in range(20):
        n = rng.randint(1, 30)
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        assert tve.voc_ap(rec, prec, use_07) == jve.voc_ap(rec, prec, use_07)
    assert tve.voc_ap(np.asarray([]), np.asarray([]), use_07) == \
        jve.voc_ap(np.asarray([]), np.asarray([]), use_07)


def test_merge_from_and_reset():
    records, dets = seeded_case(3)
    whole = tve.PascalVOCEvaluator(NAMES, novel_class_ids=(1,))
    a = tve.PascalVOCEvaluator(NAMES, novel_class_ids=(1,))
    b = tve.PascalVOCEvaluator(NAMES, novel_class_ids=(1,))
    for i, (rec, det) in enumerate(zip(records, dets)):
        for ev in (whole, a if i < 6 else b):
            ev.process_gt_record(rec)
            ev.process(*det)
    a.merge_from(b)
    assert a.evaluate() == whole.evaluate()
    whole.reset()
    assert whole.evaluate()["bbox"]["AP50"] == 0.0
