#!/usr/bin/env python
"""Write a miniature COCO-layout dataset ("shapes-COCO") on disk, for the
PyTorch/CUDA port (twin of scripts/make_shapes_coco.py, without JAX).

Real JPEG files and real COCO instances JSON (bbox xywh, polygon
segmentations, the 80 categories) in the layout ``RegisterCOCO`` reads,
``<root>/annotations/instances_<split>.json`` and ``<root>/<split>/``:

    train2017 and val2017, and train2014 linked to train2017 (the shipped
    COCO recipes read ``coco_train_2014`` as their image-level stream).

Each of the 80 COCO classes is drawn as its own (shape, hue) pair (5
polygonal shapes x 16 hues), as the same polygons that are annotated, so the
segmentation GT is pixel-exact.  With the same arguments it writes the same
files as scripts/make_shapes_coco.py.

Usage:
  python scripts/make_shapes_coco_torch.py --root DIR \
      --train-images 300 --val-images 60 --size 320

``write_shapes_coco(root, ...)`` does the same from Python.
"""

import argparse
import colorsys
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from unit_tpu_torch.models.similarity import COCO_CLASSES  # noqa: E402

_SHAPES = ["circle", "square", "triangle", "star", "bar"]


def _hue_rgb(k: int, n: int = 16):
    r, g, b = colorsys.hsv_to_rgb(k / n, 0.85, 0.85)
    return int(r * 255), int(g * 255), int(b * 255)


CLASS_STYLE = {
    name: (_SHAPES[i % 5], _hue_rgb(i // 5)) for i, name in enumerate(COCO_CLASSES)
}


def shape_polygon(shape, x1, y1, x2, y2):
    """The polygon(s) of a shape inside a box: a list of [(x, y), ...]."""
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    w, h = x2 - x1, y2 - y1
    if shape == "circle":  # an ellipse as a 16-gon
        return [[(cx + w / 2 * np.cos(a), cy + h / 2 * np.sin(a))
                 for a in np.linspace(0, 2 * np.pi, 16, endpoint=False)]]
    if shape == "square":
        return [[(x1, y1), (x2, y1), (x2, y2), (x1, y2)]]
    if shape == "triangle":
        return [[(cx, y1), (x2, y2), (x1, y2)]]
    if shape == "star":
        pts = []
        for k in range(10):
            ang = -np.pi / 2 + k * np.pi / 5
            r = (w / 2) if k % 2 == 0 else (w / 5)
            pts.append((cx + r * np.cos(ang), cy + r * np.sin(ang) * h / w))
        return [pts]
    if shape == "bar":  # a plus sign: two rectangles, one annotation of two polygons
        return [
            [(x1, cy - h / 6), (x2, cy - h / 6), (x2, cy + h / 6), (x1, cy + h / 6)],
            [(cx - w / 6, y1), (cx + w / 6, y1), (cx + w / 6, y2), (cx - w / 6, y2)],
        ]
    raise ValueError(shape)


def make_image(rng, size, class_idxs):
    """A size x size PIL image with one shape per class index, and its COCO
    annotations (1-based category ids)."""
    from PIL import Image, ImageDraw

    bg = rng.randint(90, 170, (size // 16, size // 16, 3)).astype(np.uint8)
    img = Image.fromarray(bg).resize((size, size), Image.BILINEAR)
    draw = ImageDraw.Draw(img)
    for _ in range(6):
        gx, gy = rng.randint(0, size - 12, 2)
        gw = rng.randint(6, 18)
        g = int(rng.randint(60, 200))
        draw.ellipse([gx, gy, gx + gw, gy + gw], fill=(g, g, g))

    annos = []
    occupied = []
    for ci in class_idxs:
        shape, color = CLASS_STYLE[COCO_CLASSES[ci]]
        for _ in range(40):
            s = rng.randint(size // 6, size // 3)
            bx1 = rng.randint(2, size - s - 2)
            by1 = rng.randint(2, size - s - 2)
            bx2, by2 = bx1 + s, min(by1 + int(s * rng.uniform(0.7, 1.3)), size - 2)
            if all(bx2 < ox1 or bx1 > ox2 or by2 < oy1 or by1 > oy2
                   for ox1, oy1, ox2, oy2 in occupied):
                break
        occupied.append((bx1, by1, bx2, by2))
        jitter = rng.randint(-20, 20, 3)
        c = tuple(int(np.clip(color[i] + jitter[i], 0, 255)) for i in range(3))
        polys = shape_polygon(shape, bx1, by1, bx2, by2)
        for pts in polys:
            draw.polygon([(float(x), float(y)) for x, y in pts], fill=c, outline=(0, 0, 0))
        seg = [[float(v) for xy in pts for v in xy] for pts in polys]
        xs = [x for pts in polys for x, _ in pts]
        ys = [y for pts in polys for _, y in pts]
        x1b, y1b = max(min(xs), 0.0), max(min(ys), 0.0)
        wb, hb = min(max(xs), size) - x1b, min(max(ys), size) - y1b
        annos.append({
            "category_id": int(ci) + 1,
            "bbox": [x1b, y1b, wb, hb],
            "area": wb * hb / 2.0,
            "iscrowd": 0,
            "segmentation": seg,
        })
    return img, annos


def write_split(root, split, n_images, rng, size):
    """``n_images`` images of 1-3 shapes each and their instances JSON."""
    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        img_id = i + 1
        fname = f"{split}_{img_id:06d}.jpg"
        k = rng.randint(1, 4)
        class_idxs = rng.choice(80, size=k, replace=False)
        img, annos = make_image(rng, size, class_idxs)
        img.save(os.path.join(img_dir, fname), quality=90)
        images.append({"id": img_id, "file_name": fname, "width": size, "height": size})
        for a in annos:
            annotations.append(dict(a, id=ann_id, image_id=img_id))
            ann_id += 1
    data = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": n} for i, n in enumerate(COCO_CLASSES)],
    }
    with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
        json.dump(data, f)
    return len(images), len(annotations)


def write_shapes_coco(root, train_images=300, val_images=60, size=320, seed=23):
    """train2017, val2017 and train2014 (links to train2017) under ``root``.
    Returns {split: (images, annotations)}."""
    rng = np.random.RandomState(seed)
    out = {"train2017": write_split(root, "train2017", train_images, rng, size),
           "val2017": write_split(root, "val2017", val_images, rng, size)}
    # the recipes' image-level stream reads train2014: links relative to
    # their own directory, so they resolve wherever the root is read from
    t14 = os.path.join(root, "train2014")
    if not os.path.exists(t14):
        os.symlink("train2017", t14)
    a14 = os.path.join(root, "annotations", "instances_train2014.json")
    if not os.path.exists(a14):
        os.symlink("instances_train2017.json", a14)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--train-images", type=int, default=300)
    ap.add_argument("--val-images", type=int, default=60)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--seed", type=int, default=23)
    args = ap.parse_args()
    counts = write_shapes_coco(args.root, args.train_images, args.val_images, args.size,
                               args.seed)
    (nt, at), (nv, av) = counts["train2017"], counts["val2017"]
    print(f"shapes-COCO at {args.root}: train {nt} imgs/{at} annos, val {nv} imgs/{av} annos")


if __name__ == "__main__":
    main()
