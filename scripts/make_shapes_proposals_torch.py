#!/usr/bin/env python
"""Write MCG-style precomputed proposal files for a COCO-layout dataset, for
the PyTorch/CUDA port (the idea of scripts/make_shapes_proposals.py, without
JAX).

The dock recipe (configs/COCO/COCO-VGG-CNN-F-split1-dock.yaml) reads external
proposals (DATASETS.PROPOSAL_FILES_*, MODEL.LOAD_PROPOSALS) in place of the
RPN.  This stand-in gives each image its GT boxes, ``jitter`` jittered copies
of each and ``per_image`` random boxes, seeded, with scores falling from 1 to
0 in that order, in the {image_id: {"boxes": [N, 4] XYXY, "scores": [N]}}
pickle that ``unit_tpu_torch.data.proposals.load_proposal_file`` reads:

  python scripts/make_shapes_proposals_torch.py --root DIR \
      --splits train2014 val2014 --per-image 100

writes DIR/proposals_<split>.pkl.  ``write_proposals(root, ...)`` does the
same from Python and ``mcg_like_proposals`` makes one image's.
"""

import argparse
import json
import os
import pickle

import numpy as np


def mcg_like_proposals(gt_boxes, width, height, rng, per_image=100, jitter=8):
    """(boxes [N, 4] f32 XYXY, scores [N] f32) of one width x height image:
    ``gt_boxes`` [G, 4] XYXY, ``jitter`` copies of each moved by N(0, 4 px)
    and clipped, and ``per_image`` random boxes of 16 px up to half the image
    a side; scores from 1 down to 0 in that order."""
    gt = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    lim = np.asarray([width, height, width, height], np.float32)
    parts = [gt]
    for g in gt:
        parts.append(np.clip(g[None] + rng.randn(jitter, 4) * 4.0, 0, lim).astype(np.float32))
    x1 = rng.rand(per_image) * (width - 16)
    y1 = rng.rand(per_image) * (height - 16)
    bw = 16 + rng.rand(per_image) * (width / 2)
    bh = 16 + rng.rand(per_image) * (height / 2)
    parts.append(np.stack([x1, y1, np.minimum(x1 + bw, width), np.minimum(y1 + bh, height)],
                          axis=1).astype(np.float32))
    boxes = np.concatenate(parts)
    return boxes, np.linspace(1.0, 0.0, len(boxes)).astype(np.float32)


def write_proposals(root, splits=("train2014", "val2014"), per_image=100, seed=11):
    """``root``/proposals_<split>.pkl for each split's
    annotations/instances_<split>.json; returns the paths."""
    rng = np.random.RandomState(seed)
    paths = []
    for split in splits:
        with open(os.path.join(root, "annotations", f"instances_{split}.json")) as f:
            data = json.load(f)
        gts = {}
        for a in data["annotations"]:
            x, y, w, h = a["bbox"]
            gts.setdefault(a["image_id"], []).append([x, y, x + w, y + h])
        out = {}
        for im in data["images"]:
            boxes, scores = mcg_like_proposals(gts.get(im["id"], []), im["width"],
                                               im["height"], rng, per_image)
            out[str(im["id"])] = {"boxes": boxes, "scores": scores}
        path = os.path.join(root, f"proposals_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(out, f)
        paths.append(path)
    return paths


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--splits", nargs="+", default=["train2014", "val2014"])
    ap.add_argument("--per-image", type=int, default=100)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    for path in write_proposals(args.root, args.splits, args.per_image, args.seed):
        print(path)


if __name__ == "__main__":
    main()
