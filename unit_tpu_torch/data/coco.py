"""COCO dataset parsing and few-shot split registration.

Port of unit_tpu/data/coco.py (numpy only): COCO instances JSON -> records
with contiguous category ids in model order, the base-training query splits
filtered to the 60 base classes (split1: the 20 VOC-overlapping classes are
novel), the image-level classifier datasets and the seeded k-shot fine-tuning
split.  Under MODEL.MASK_ON each polygon annotation is rasterised into a
fixed-resolution bitmask in its GT box's frame (the mask head's training
target) and keeps its raw polygons, from which the segm evaluator rasterises
the image-frame mask.  The masks are bit-identical to unit_tpu's.

``RegisterCOCONote`` and ``RegisterCOCODock`` register the same family under
the note and dock suites' prefixes (``coco_note_*``, ``coco_dock_*``), their
``*_base_training_support`` sets among them: the support shots of a meta
model over InceptionResNetV2 or VGG-CNN-F.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from ..models.similarity import COCO_CLASSES
from .catalog import DatasetCatalog, MetadataCatalog


def polygons_to_boxmask(polys: List[List[float]], box, size: int = 28) -> np.ndarray:
    """Rasterize COCO polygon(s) into a size x size mask in the box frame."""
    x1, y1, x2, y2 = box
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    mask = np.zeros((size, size), bool)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        px = (pts[:, 0] - x1) / w * size
        py = (pts[:, 1] - y1) / h * size
        mask |= _fill_poly(px, py, size)
    return mask


def rasterize_polygons(polys: List[List[float]], height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygon(s) at the image's resolution (pixel-centre
    sampling, even-odd rule within a polygon, union across polygons): the
    counterpart of pycocotools' RLE GT masks for segm evaluation.  Only the
    rows inside each polygon's vertical extent are scanned, and each row's
    edge crossings are computed for all edges at once."""
    mask = np.zeros((height, width), bool)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        x0, y0 = pts[:, 0], pts[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        lo = max(int(np.floor(y0.min() - 0.5)), 0)
        hi = min(int(np.ceil(y0.max() + 0.5)), height)
        if hi <= lo:
            continue
        ys = np.arange(lo, hi) + 0.5                        # [R] row centres
        # crossing test per (row, edge), half-open so a shared vertex counts once
        crosses = ((y0[None] <= ys[:, None]) & (ys[:, None] < y1[None])) | (
            (y1[None] <= ys[:, None]) & (ys[:, None] < y0[None])
        )
        dy = np.where(y1 - y0 != 0, y1 - y0, 1.0)
        t = (ys[:, None] - y0[None]) / dy[None]
        xc = np.where(crosses, x0[None] + t * (x1[None] - x0[None]), np.inf)
        xc.sort(axis=1)                                      # the crossings first
        counts = crosses.sum(axis=1)
        for r in range(len(ys)):
            for a, b in zip(xc[r, 0:counts[r]:2], xc[r, 1:counts[r]:2]):
                ca = max(int(np.ceil(a - 0.5)), 0)
                cb = min(int(np.floor(b - 0.5)) + 1, width)
                if cb > ca:
                    mask[lo + r, ca:cb] = True
    return mask


def _fill_poly(px: np.ndarray, py: np.ndarray, size: int) -> np.ndarray:
    """Scanline polygon fill (even-odd rule) on a small grid."""
    mask = np.zeros((size, size), bool)
    n = len(px)
    if n < 3:
        return mask
    ys = np.arange(size) + 0.5
    for yi, y in enumerate(ys):
        xs = []
        for i in range(n):
            x0, y0 = px[i], py[i]
            x1, y1 = px[(i + 1) % n], py[(i + 1) % n]
            if (y0 <= y < y1) or (y1 <= y < y0):
                t = (y - y0) / (y1 - y0)
                xs.append(x0 + t * (x1 - x0))
        xs.sort()
        for a, b in zip(xs[0::2], xs[1::2]):
            lo = max(int(np.ceil(a - 0.5)), 0)
            hi = min(int(np.floor(b - 0.5)) + 1, size)
            if hi > lo:
                mask[yi, lo:hi] = True
    return mask


def load_coco_json(
    json_file: str,
    image_root: str,
    class_ids_to_include: Sequence[int] | None = None,
    with_masks: bool = False,
    mask_size: int = 28,
) -> List[dict]:
    """COCO instances JSON -> records (contiguous category ids in model order).
    Annotations marked ``ignore`` and images left without annotations are
    dropped."""
    with open(json_file) as f:
        data = json.load(f)
    cat_list = sorted(data["categories"], key=lambda c: c["id"])
    cat_to_contiguous = {c["id"]: i for i, c in enumerate(cat_list)}
    imgs = {im["id"]: im for im in data["images"]}
    anns_per_img: Dict[int, list] = {}
    for ann in data["annotations"]:
        if ann.get("ignore", 0):
            continue
        anns_per_img.setdefault(ann["image_id"], []).append(ann)

    out = []
    for img_id, im in imgs.items():
        record = {
            "image_id": str(img_id),
            "file_name": os.path.join(image_root, im["file_name"]),
            "height": im["height"],
            "width": im["width"],
            "annotations": [],
        }
        for ann in anns_per_img.get(img_id, []):
            cid = cat_to_contiguous.get(ann["category_id"])
            if cid is None:
                continue
            if class_ids_to_include is not None and cid not in class_ids_to_include:
                continue
            x, y, w, h = ann["bbox"]
            rec_ann = {
                "category_id": cid,
                "bbox": [x, y, x + w, y + h],
                "area": ann.get("area", w * h),
                "iscrowd": ann.get("iscrowd", 0),
            }
            if with_masks and isinstance(ann.get("segmentation"), list):
                rec_ann["box_mask"] = polygons_to_boxmask(
                    ann["segmentation"], rec_ann["bbox"], mask_size
                )
                # the raw polygons, for the pixel-exact GT mask at evaluation
                rec_ann["segmentation"] = ann["segmentation"]
            record["annotations"].append(rec_ann)
        if record["annotations"]:
            out.append(record)
    return out


class RegisterCOCO:
    """Registers the COCO few-shot family:

      coco_base_training_query_train    train split, base-class boxes only
      coco_base_training_query_val      val split, all classes
      coco_fine_tuning_query_train      seeded k-shot over all classes
      coco_fine_tuning_query_val        val split, all classes
      coco_base_training_support        base-class records by class
      coco_train_2014 / coco_train_2017 image-level classifier datasets

    under ``root`` (DATASETS.CLASSIFIER_DATAROOT by default), laid out as
    ``annotations/instances_<split>.json`` and ``<split>/<file_name>``.
    """

    prefix = "coco"
    train_split = "train2017"
    val_split = "val2017"

    def __init__(self, cfg, root: str | None = None):
        self.cfg = cfg
        self.root = root or cfg.DATASETS.CLASSIFIER_DATAROOT
        self.base_ids = list(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
        self.all_ids = sorted(
            set(self.base_ids) | set(cfg.DATASETS.FEWSHOT.NOVEL_CLASSES_ID)
        )
        self.shots = cfg.DATASETS.FEWSHOT.NUM_SHOTS
        self.seed = cfg.DATASETS.SAMPLE_SEED
        self.with_masks = cfg.MODEL.MASK_ON

    def _paths(self, split: str):
        ann = os.path.join(self.root, "annotations", f"instances_{split}.json")
        img = os.path.join(self.root, split)
        return ann, img

    def _register(self, name: str, fn):
        DatasetCatalog.register(name, fn, overwrite=name in DatasetCatalog)
        MetadataCatalog.get(name).set(
            thing_classes=list(COCO_CLASSES), evaluator_type="coco"
        )

    def register_all(self):
        p = self.prefix

        def base_train():
            ann, img = self._paths(self.train_split)
            return load_coco_json(ann, img, self.base_ids, self.with_masks)

        def val():
            ann, img = self._paths(self.val_split)
            return load_coco_json(ann, img, None, self.with_masks)

        def ft_train():
            from .voc import kshot_sample

            ann, img = self._paths(self.train_split)
            recs = load_coco_json(ann, img, self.all_ids, self.with_masks)
            return kshot_sample(recs, self.shots, self.all_ids, self.seed)

        def classifier(split):
            def load():
                ann, img = self._paths(split)
                return load_coco_json(ann, img, None, False)

            return load

        def support():
            ann, img = self._paths(self.train_split)
            recs = load_coco_json(ann, img, self.base_ids, False)
            by_class = {c: [] for c in self.base_ids}
            for rec in recs:
                for c in {a["category_id"] for a in rec["annotations"]}:
                    if c in by_class:
                        by_class[c].append(rec)
            return by_class

        DatasetCatalog.register(
            f"{p}_base_training_support", support,
            overwrite=f"{p}_base_training_support" in DatasetCatalog,
        )
        self._register(f"{p}_base_training_query_train", base_train)
        self._register(f"{p}_base_training_query_val", val)
        self._register(f"{p}_fine_tuning_query_train", ft_train)
        self._register(f"{p}_fine_tuning_query_val", val)
        # image-level classifier datasets: one per year, shared across suites
        self._register("coco_train_2014", classifier("train2014"))
        self._register("coco_train_2017", classifier("train2017"))


class RegisterCOCONote(RegisterCOCO):
    """``coco_note_*``: the suite over COCO2017 of the InceptionResNetV2
    experiments."""

    prefix = "coco_note"
    train_split = "train2017"
    val_split = "val2017"


class RegisterCOCODock(RegisterCOCO):
    """``coco_dock_*``: the suite over COCO2014 whose models read precomputed
    MCG proposals (DATASETS.PROPOSAL_FILES_*)."""

    prefix = "coco_dock"
    train_split = "train2014"
    val_split = "val2014"
