"""Seeded image data: natural-looking pixels, JPEG bytes, and the two
dataset layouts the recipes read (a VOCdevkit, a COCO instances tree).

Patterns from chip_smoke.py (``natural_image``, ``write_jpeg``,
``write_devkit``) and scripts/make_shapes_coco_torch.py (the polygons)."""

from __future__ import annotations

import io
import json
import os
from typing import List, Sequence, Tuple

import numpy as np

VOC_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
               "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
               "pottedplant", "sheep", "sofa", "train", "tvmonitor")

_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>"""
_OBJ = """<object><name>{name}</name><difficult>0</difficult>
  <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
</object>"""


def natural_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """uint8 RGB [h, w, 3] with a photo's smoothness: a coarse random field,
    bicubically enlarged, plus a little noise (white noise would decode ~3x
    slower than a photo and time the wrong JPEG)."""
    from PIL import Image

    coarse = rng.randint(0, 256, (max(h // 24, 2), max(w // 24, 2), 3)).astype(np.uint8)
    big = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.float32)
    return np.clip(big + rng.normal(0, 6, big.shape), 0, 255).astype(np.uint8)


def jpeg_bytes(rgb: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def shapes_for(n: int, shapes: Sequence[Tuple[int, int]], rng) -> List[Tuple[int, int]]:
    """``n`` (h, w) sizes, the orientations in equal shares, in a seeded order."""
    sizes = [tuple(shapes[i % len(shapes)]) for i in range(n)]
    return [sizes[i] for i in rng.permutation(n)]


def random_boxes(rng, h: int, w: int, count: int) -> List[Tuple[int, int, int, int]]:
    """``count`` boxes of 1/10 to 1/2 of the image's sides, inside it."""
    out = []
    for _ in range(count):
        bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
        x1, y1 = rng.randint(1, w - bw), rng.randint(1, h - bh)
        out.append((x1, y1, x1 + bw, y1 + bh))
    return out


def write_voc(root: str, seed: int, n_images: int, shapes, boxes: Tuple[int, int],
              base_ids: Sequence[int]) -> dict:
    """A VOCdevkit of ``n_images`` JPEGs, half in VOC2007 trainval and half in
    VOC2012 trainval, each of ``boxes`` (lo, hi) boxes; the first box is of a
    base class, so every image is in the strong stream too.  Returns what was
    written by image id: {file, height, width, boxes (as written), classes}."""
    rng = np.random.RandomState(seed % 2**32)
    sizes = shapes_for(n_images, shapes, rng)
    per_year = {"2007": [], "2012": []}
    manifest = {}
    for i, (h, w) in enumerate(sizes):
        year = "2007" if i % 2 == 0 else "2012"
        base = os.path.join(root, f"VOC{year}")
        image_id = f"{year}_{i:05d}"
        per_year[year].append(image_id)
        n = rng.randint(boxes[0], boxes[1] + 1)
        bxs = random_boxes(rng, h, w, n)
        classes = [int(base_ids[rng.randint(len(base_ids))])] + [
            int(rng.randint(len(VOC_CLASSES))) for _ in range(n - 1)]
        path = os.path.join(base, "JPEGImages", f"{image_id}.jpg")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(jpeg_bytes(natural_image(rng, h, w)))
        objs = "\n".join(_OBJ.format(name=VOC_CLASSES[c], x1=b[0], y1=b[1], x2=b[2], y2=b[3])
                         for b, c in zip(bxs, classes))
        ann = os.path.join(base, "Annotations", f"{image_id}.xml")
        os.makedirs(os.path.dirname(ann), exist_ok=True)
        with open(ann, "w") as f:
            f.write(_XML.format(w=w, h=h, objects=objs))
        manifest[image_id] = {"file": path, "height": h, "width": w, "boxes": bxs,
                              "classes": classes}
    for year, ids in per_year.items():
        sets = os.path.join(root, f"VOC{year}", "ImageSets", "Main")
        os.makedirs(sets, exist_ok=True)
        with open(os.path.join(sets, "trainval.txt"), "w") as f:
            f.write("\n".join(ids))
    return manifest


def ellipse_polygon(x1: float, y1: float, x2: float, y2: float, n: int = 16):
    cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
    return [(cx + rx * np.cos(a), cy + ry * np.sin(a))
            for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]


def write_coco(root: str, seed: int, n_images: int, shapes, boxes: Tuple[int, int],
               base_ids: Sequence[int], splits: Sequence[str]) -> dict:
    """A COCO instances tree of ``n_images`` JPEGs under ``<root>/<split>``
    for the first of ``splits`` (the others are links to it), each of
    ``boxes`` (lo, hi) instances with a polygon (an ellipse in its box); the
    first instance is of a base class.  Category ids are 1..80.  Returns
    what was written by image id: {file, height, width, boxes, classes
    (0..79), polygons}."""
    rng = np.random.RandomState(seed % 2**32)
    first = splits[0]
    img_dir = os.path.join(root, first)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, annotations, manifest = [], [], {}
    for i, (h, w) in enumerate(shapes_for(n_images, shapes, rng)):
        img_id = i + 1
        fname = f"{first}_{img_id:06d}.jpg"
        path = os.path.join(img_dir, fname)
        n = rng.randint(boxes[0], boxes[1] + 1)
        bxs = random_boxes(rng, h, w, n)
        classes = [int(base_ids[rng.randint(len(base_ids))])] + [
            int(rng.randint(80)) for _ in range(n - 1)]
        with open(path, "wb") as f:
            f.write(jpeg_bytes(natural_image(rng, h, w)))
        images.append({"id": img_id, "file_name": fname, "width": w, "height": h})
        manifest[str(img_id)] = {"file": path, "height": h, "width": w, "boxes": bxs,
                                 "classes": classes, "polygons": []}
        for b, c in zip(bxs, classes):
            poly = ellipse_polygon(*b)
            manifest[str(img_id)]["polygons"].append([float(v) for xy in poly for v in xy])
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id, "category_id": c + 1,
                "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                "area": float(np.pi * (b[2] - b[0]) * (b[3] - b[1]) / 4), "iscrowd": 0,
                "segmentation": [[float(v) for xy in poly for v in xy]]})
    data = {"images": images, "annotations": annotations,
            "categories": [{"id": c + 1, "name": f"class_{c}"} for c in range(80)]}
    for split in splits:
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump(data, f)
        if split != first:
            os.symlink(first, os.path.join(root, split))
    return manifest
