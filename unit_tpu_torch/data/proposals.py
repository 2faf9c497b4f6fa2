"""Precomputed (MCG) proposal files for MODEL.LOAD_PROPOSALS.

Port of unit_tpu/data/proposals.py (numpy only).  A proposal file maps
image_id -> {"boxes": [N, 4] XYXY in the original image, "scores": [N]}
(a pickle, or an .npz holding it under "proposals"; parallel "ids" / "boxes"
/ "scores" (or "objectness_logits") lists are read too).  The loaders attach
each image's top-K by score (``attach_proposals``) and pad them to a fixed
capacity in the network's frame (``pad_record_proposals``): scaled with the
image, clipped to it, and invalid where empty after the clip.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np


def load_proposal_file(path: str) -> Dict[str, dict]:
    """A proposal pickle or npz -> {str(image_id): {boxes, scores}}."""
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
        obj = data["proposals"].item() if "proposals" in data else data
    else:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    if "ids" in obj and "boxes" in obj:
        scores = obj.get("objectness_logits", obj.get("scores"))
        return {str(image_id): {"boxes": np.asarray(obj["boxes"][i], np.float32),
                                "scores": np.asarray(scores[i], np.float32)}
                for i, image_id in enumerate(obj["ids"])}
    return {
        str(k): {
            "boxes": np.asarray(v["boxes"], np.float32),
            "scores": np.asarray(v.get("scores", v.get("objectness_logits")), np.float32),
        }
        for k, v in obj.items()
    }


def attach_proposals(records: List[dict], proposal_files, topk: int) -> List[dict]:
    """Give each record of an image in the files (that exist) its top-``topk``
    proposals by score, in place: ``proposals`` [K, 4] and
    ``proposal_scores`` [K].  Records of images the files lack are left as
    they are."""
    table: Dict[str, dict] = {}
    for path in proposal_files or ():
        if os.path.exists(path):
            table.update(load_proposal_file(path))
    if not table:
        return records
    for rec in records:
        entry = table.get(str(rec["image_id"]))
        if entry is None:
            continue
        order = np.argsort(-entry["scores"])[:topk]
        rec["proposals"] = entry["boxes"][order]
        rec["proposal_scores"] = entry["scores"][order]
    return records


def pad_record_proposals(rec: dict, scale: float, capacity: int,
                         new_w: Optional[float] = None, new_h: Optional[float] = None):
    """(boxes [capacity, 4], valid [capacity]) in the network's frame: the
    record's proposals times ``scale``, clipped to [0, new_w] x [0, new_h],
    valid where non-empty after the clip; zeros and invalid past them (all
    of them for a record without proposals)."""
    boxes = np.zeros((capacity, 4), np.float32)
    valid = np.zeros((capacity,), bool)
    props = rec.get("proposals")
    if props is not None and len(props):
        n = min(len(props), capacity)
        b = props[:n] * scale
        if new_w is not None:
            b[:, 0::2] = np.clip(b[:, 0::2], 0.0, float(new_w))
        if new_h is not None:
            b[:, 1::2] = np.clip(b[:, 1::2], 0.0, float(new_h))
        boxes[:n] = b
        valid[:n] = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
    return boxes, valid
