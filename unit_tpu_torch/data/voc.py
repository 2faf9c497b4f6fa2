"""PASCAL VOC dataset parsing and few-shot split registration (the port's
copy of unit_tpu/data/voc.py: numpy and the standard library only).

Rebuild of the reference repo's data/datasets/voc/{base_training,fine_tuning}.py and the
darknet pipelines-adaptor machinery it wraps: VOC XML -> d2-style records, base
training query splits filtered to base-class boxes, image-level classifier
datasets, and deterministic seeded k-shot fine-tuning splits.  (The reference
reproduces the exact bingykang/Fewshot_Detection split files; without network
access we generate k-shot splits with a seeded RNG, which is the same protocol
with a different fixed seed.)
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence

import numpy as np

from .catalog import DatasetCatalog, MetadataCatalog
from ..models.similarity import VOC_CLASSES


def parse_voc_xml(xml_path: str, class_ids_to_include: Sequence[int] | None = None) -> dict:
    """One VOC annotation file -> record dict (XML->dict path of the reference,
    base_training.py:190-220; boxes converted from 1-based inclusive to 0-based)."""
    tree = ET.parse(xml_path)
    lab2int = {n: i for i, n in enumerate(VOC_CLASSES)}
    record = {
        "image_id": os.path.splitext(os.path.basename(xml_path))[0],
        "height": int(tree.findall("./size/height")[0].text),
        "width": int(tree.findall("./size/width")[0].text),
        "annotations": [],
    }
    for obj in tree.findall("object"):
        cls_name = obj.find("name").text
        if cls_name not in lab2int:
            continue
        cid = lab2int[cls_name]
        if class_ids_to_include is not None and cid not in class_ids_to_include:
            continue
        bb = obj.find("bndbox")
        bbox = [float(bb.find(x).text) for x in ["xmin", "ymin", "xmax", "ymax"]]
        bbox[0] -= 1.0
        bbox[1] -= 1.0
        diff = obj.find("difficult")
        record["annotations"].append({
            "category_id": cid,
            "bbox": bbox,
            "difficult": int(diff.text) if diff is not None else 0,
        })
    return record


def load_voc_split(
    devkit_root: str,
    year: str,
    split: str,
    class_ids_to_include: Sequence[int] | None = None,
    keep_empty: bool = False,
) -> List[dict]:
    """Load a VOCdevkit split (e.g. VOC2007 trainval) into records."""
    voc_dir = os.path.join(devkit_root, f"VOC{year}")
    split_file = os.path.join(voc_dir, "ImageSets", "Main", f"{split}.txt")
    with open(split_file) as f:
        ids = [line.strip().split()[0] for line in f if line.strip()]
    out = []
    for image_id in ids:
        xml_path = os.path.join(voc_dir, "Annotations", f"{image_id}.xml")
        rec = parse_voc_xml(xml_path, class_ids_to_include)
        rec["file_name"] = os.path.join(voc_dir, "JPEGImages", f"{image_id}.jpg")
        if rec["annotations"] or keep_empty:
            out.append(rec)
    return out


def kshot_sample(
    records: List[dict], shots: int, class_ids: Sequence[int], seed: int
) -> List[dict]:
    """Deterministic k-shot selection: for each class pick images until exactly
    ``shots`` boxes of that class are accumulated (the standard few-shot VOC
    protocol used by the reference's split files)."""
    rng = np.random.RandomState(seed)
    by_class: Dict[int, List[dict]] = {c: [] for c in class_ids}
    for rec in records:
        cats = {a["category_id"] for a in rec["annotations"]}
        for c in cats:
            if c in by_class:
                by_class[c].append(rec)
    chosen: Dict[str, dict] = {}
    for c in class_ids:
        pool = by_class[c]
        order = rng.permutation(len(pool))
        count = 0
        for i in order:
            rec = pool[i]
            n_boxes = sum(1 for a in rec["annotations"] if a["category_id"] == c)
            if count + n_boxes > shots and count > 0:
                continue
            key = rec["image_id"]
            if key not in chosen:
                filtered = dict(rec)
                filtered["annotations"] = [
                    a for a in rec["annotations"] if a["category_id"] in class_ids
                ]
                chosen[key] = filtered
            count += n_boxes
            if count >= shots:
                break
    return list(chosen.values())


def load_kshot_split_files(
    split_dir: str, shots: int, class_names: Sequence[str], devkit_root: str
) -> List[dict] | None:
    """Load canonical few-shot split files when present (the
    bingykang/Fewshot_Detection `box_{K}shot_{cls}_train.txt` layout that the
    reference's pipelines_adaptor reproduces).  Returns None if absent so the
    caller falls back to seeded sampling."""
    if not os.path.isdir(split_dir):
        return None
    chosen: dict = {}
    found_any = False
    for cid, name in enumerate(class_names):
        path = os.path.join(split_dir, f"box_{shots}shot_{name}_train.txt")
        if not os.path.exists(path):
            continue
        found_any = True
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                image_id = os.path.splitext(os.path.basename(line))[0]
                year = "2012" if "2012" in line else "2007"
                xml = os.path.join(
                    devkit_root, f"VOC{year}", "Annotations", f"{image_id}.xml"
                )
                if image_id not in chosen and os.path.exists(xml):
                    rec = parse_voc_xml(xml)
                    rec["file_name"] = os.path.join(
                        devkit_root, f"VOC{year}", "JPEGImages", f"{image_id}.jpg"
                    )
                    chosen[image_id] = rec
    return list(chosen.values()) if found_any else None


class RegisterVOC:
    """Registers the VOC few-shot dataset family (register_voc.py:5-22):

      voc_base_training_query_train — VOC07+12 trainval, base-class boxes only
      voc_base_training_query_val   — VOC2007 test, all classes
      voc_base_training_support     — per-class support shots (meta stream)
      voc_fine_tuning_query_train   — seeded k-shot boxes over all classes
      pascal_trainval_2007/2012     — image-level classifier datasets
    """

    def __init__(self, cfg, devkit_root: str | None = None):
        self.cfg = cfg
        self.root = devkit_root or cfg.DATASETS.CLASSIFIER_DATAROOT
        self.base_ids = list(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
        self.all_ids = sorted(
            set(self.base_ids) | set(cfg.DATASETS.FEWSHOT.NOVEL_CLASSES_ID)
        )
        self.shots = cfg.DATASETS.FEWSHOT.NUM_SHOTS
        self.seed = cfg.DATASETS.SAMPLE_SEED

    def _register(self, name: str, fn, **meta):
        if name in DatasetCatalog:
            DatasetCatalog.register(name, fn, overwrite=True)
        else:
            DatasetCatalog.register(name, fn)
        MetadataCatalog.get(name).set(
            thing_classes=list(VOC_CLASSES), evaluator_type="pascal_voc", **meta
        )

    def register_all(self):
        root = self.root

        def base_train():
            recs = load_voc_split(root, "2007", "trainval", self.base_ids)
            recs += load_voc_split(root, "2012", "trainval", self.base_ids)
            return recs

        def val():
            return load_voc_split(root, "2007", "test", None, keep_empty=True)

        def ft_train():
            # canonical split files take precedence when available
            canonical = load_kshot_split_files(
                os.path.join(os.path.dirname(root.rstrip("/")), "vocsplit"),
                self.shots, VOC_CLASSES, root,
            )
            if canonical:
                return canonical
            recs = load_voc_split(root, "2007", "trainval", self.all_ids)
            recs += load_voc_split(root, "2012", "trainval", self.all_ids)
            return kshot_sample(recs, self.shots, self.all_ids, self.seed)

        self._register("voc_base_training_query_train", base_train)
        self._register(
            "voc_base_training_query_val", val,
            dirname=os.path.join(root, "VOC2007"), year=2007, split="test",
        )
        self._register("voc_fine_tuning_query_train", ft_train)
        self._register("voc_fine_tuning_query_val", val,
                       dirname=os.path.join(root, "VOC2007"), year=2007, split="test")
        # image-level classifier datasets (cfg.DATASETS.CLASSIFIER_TRAIN)
        self._register(
            "pascal_trainval_2007",
            lambda: load_voc_split(root, "2007", "trainval", None),
        )
        self._register(
            "pascal_trainval_2012",
            lambda: load_voc_split(root, "2012", "trainval", None),
        )

        def support():
            recs = load_voc_split(root, "2007", "trainval", self.base_ids)
            recs += load_voc_split(root, "2012", "trainval", self.base_ids)
            by_class = {c: [] for c in self.base_ids}
            for rec in recs:
                for c in {a["category_id"] for a in rec["annotations"]}:
                    if c in by_class:
                        by_class[c].append(rec)
            return by_class

        DatasetCatalog.register(
            "voc_base_training_support", support,
            overwrite="voc_base_training_support" in DatasetCatalog,
        )
        MetadataCatalog.get("voc_base_training_support").set(
            thing_classes=list(VOC_CLASSES), evaluator_type="pascal_voc"
        )
