"""roi_heads_ms.train: device ms a traced step under the program's ranges of
the ROI heads (``unit:box_heads``: the Res5 heads, ``unit:predictors``: the
supervised and weak predictors, ``unit:mask_head``), forward and backward.
ROIAlign (``unit:roi_pooling``) is not in it: it has its own roofline.
Layer: model (models/box_heads.py, fast_rcnn.py, mask_head.py, pcl.py).
Device trace."""

PARTS = ("box_heads", "predictors", "mask_head")


def read(run):
    s = run.get("summary")
    if not s or not s["steps"]:
        return None
    r = s["ranges"]
    ms = 1e3 * sum(r.get(f"{p} {w}", 0.0) for p in PARTS for w in ("fwd", "bwd"))
    return ms / s["steps"] if ms > 0 else None
