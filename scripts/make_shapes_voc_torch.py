#!/usr/bin/env python
"""Write a miniature VOCdevkit ("shapes-VOC") on disk, for the PyTorch/CUDA
port (twin of scripts/make_shapes_voc.py, without JAX).

Real JPEG files, real VOC XML annotations and ImageSets splits in the
VOCdevkit layout that ``unit_tpu_torch.data.voc`` reads:

    VOC2007/{Annotations,ImageSets/Main,JPEGImages} with trainval and test,
    VOC2012/{...} with trainval.

Each of the 20 VOC classes is drawn as its own (shape, hue) pair (5 shapes x
4 hues) over a cluttered background, so a detector has to localize and
classify.  With the same arguments it writes the same files as
scripts/make_shapes_voc.py.

Usage:
  python scripts/make_shapes_voc_torch.py --root DIR \
      --train-per-class 12 --test-per-class 4 --size 320

``write_shapes_voc(root, ...)`` does the same from Python.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from unit_tpu_torch.models.similarity import VOC_CLASSES  # noqa: E402

# 5 shapes x 4 hues = 20 class appearances
_SHAPES = ["circle", "square", "triangle", "star", "bar"]
_HUES = [
    (220, 40, 40),    # red
    (40, 190, 60),    # green
    (50, 80, 230),    # blue
    (235, 200, 40),   # yellow
]
CLASS_STYLE = {
    name: (_SHAPES[i % 5], _HUES[i // 5]) for i, name in enumerate(VOC_CLASSES)
}

_XML = """<annotation>
  <folder>{folder}</folder><filename>{fname}</filename>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  <segmented>0</segmented>
{objects}</annotation>
"""
_OBJ = """  <object>
    <name>{name}</name><pose>Unspecified</pose><truncated>0</truncated>
    <difficult>0</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>
"""


def _draw_shape(draw, shape, color, x1, y1, x2, y2):
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    w, h = x2 - x1, y2 - y1
    if shape == "circle":
        draw.ellipse([x1, y1, x2, y2], fill=color, outline=(0, 0, 0))
    elif shape == "square":
        draw.rectangle([x1, y1, x2, y2], fill=color, outline=(0, 0, 0))
    elif shape == "triangle":
        draw.polygon([(cx, y1), (x2, y2), (x1, y2)], fill=color, outline=(0, 0, 0))
    elif shape == "star":
        pts = []
        for k in range(10):
            ang = -np.pi / 2 + k * np.pi / 5
            r = (w / 2) if k % 2 == 0 else (w / 5)
            pts.append((cx + r * np.cos(ang), cy + r * np.sin(ang) * h / w))
        draw.polygon(pts, fill=color, outline=(0, 0, 0))
    elif shape == "bar":
        # a plus sign: a bar over the box's middle third each way
        draw.rectangle([x1, cy - h / 6, x2, cy + h / 6], fill=color, outline=(0, 0, 0))
        draw.rectangle([cx - w / 6, y1, cx + w / 6, y2], fill=color, outline=(0, 0, 0))


def make_image(rng, size, class_names):
    """A size x size PIL image with one object per listed class, and the
    objects as (name, x1, y1, x2, y2) in VOC's 1-based inclusive pixels."""
    from PIL import Image, ImageDraw

    # cluttered background: low-frequency noise and gray distractor blobs
    bg = rng.randint(90, 170, (size // 16, size // 16, 3)).astype(np.uint8)
    img = Image.fromarray(bg).resize((size, size), Image.BILINEAR)
    draw = ImageDraw.Draw(img)
    for _ in range(6):
        gx, gy = rng.randint(0, size - 12, 2)
        gw = rng.randint(6, 18)
        g = int(rng.randint(60, 200))
        draw.ellipse([gx, gy, gx + gw, gy + gw], fill=(g, g, g))

    objects = []
    occupied = []
    for name in class_names:
        shape, color = CLASS_STYLE[name]
        for _ in range(40):  # rejection-sample a spot clear of the others
            s = rng.randint(size // 6, size // 3)
            x1 = rng.randint(2, size - s - 2)
            y1 = rng.randint(2, size - s - 2)
            x2, y2 = x1 + s, y1 + int(s * rng.uniform(0.7, 1.3))
            y2 = min(y2, size - 2)
            if all(x2 < ox1 or x1 > ox2 or y2 < oy1 or y1 > oy2
                   for ox1, oy1, ox2, oy2 in occupied):
                break
        occupied.append((x1, y1, x2, y2))
        jitter = rng.randint(-25, 25, 3)
        c = tuple(int(np.clip(color[i] + jitter[i], 0, 255)) for i in range(3))
        _draw_shape(draw, shape, c, x1, y1, x2, y2)
        objects.append((name, x1 + 1, y1 + 1, x2, y2))
    return img, objects


def write_split(root, year, split, n_images, rng, size, start_idx=0):
    """``n_images`` images of 1-3 objects each, their XML, and their ids
    appended to ``ImageSets/Main/<split>.txt``."""
    base = os.path.join(root, f"VOC{year}")
    for d in ["Annotations", os.path.join("ImageSets", "Main"), "JPEGImages"]:
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = []
    for i in range(n_images):
        image_id = f"{year}_{split}_{start_idx + i:05d}"
        ids.append(image_id)
        k = rng.randint(1, 4)
        classes = [VOC_CLASSES[c] for c in rng.choice(20, size=k, replace=False)]
        img, objects = make_image(rng, size, classes)
        img.save(os.path.join(base, "JPEGImages", f"{image_id}.jpg"), quality=90)
        objs = "".join(
            _OBJ.format(name=n, x1=x1, y1=y1, x2=x2, y2=y2)
            for n, x1, y1, x2, y2 in objects
        )
        with open(os.path.join(base, "Annotations", f"{image_id}.xml"), "w") as f:
            f.write(_XML.format(folder=f"VOC{year}", fname=f"{image_id}.jpg",
                                w=size, h=size, objects=objs))
    with open(os.path.join(base, "ImageSets", "Main", f"{split}.txt"), "a") as f:
        f.write("\n".join(ids) + "\n")
    return ids


def write_shapes_voc(root, train_per_class=12, test_per_class=4, size=320, seed=17):
    """VOC2007 trainval and test and VOC2012 trainval under ``root``: about
    two objects an image, so ``train_per_class * 10`` training images a year
    and ``test_per_class * 10`` test images.  Returns (train, test) counts."""
    rng = np.random.RandomState(seed)
    n_train = train_per_class * 10
    n_test = test_per_class * 10
    write_split(root, "2007", "trainval", n_train, rng, size)
    write_split(root, "2007", "test", n_test, rng, size)
    write_split(root, "2012", "trainval", n_train, rng, size)
    return n_train, n_test


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--train-per-class", type=int, default=12,
                    help="approx. training object instances per class per year")
    ap.add_argument("--test-per-class", type=int, default=4)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    n_train, n_test = write_shapes_voc(args.root, args.train_per_class, args.test_per_class,
                                       args.size, args.seed)
    print(f"shapes-VOC at {args.root}: {n_train} train imgs x2 years, {n_test} test")


if __name__ == "__main__":
    main()
