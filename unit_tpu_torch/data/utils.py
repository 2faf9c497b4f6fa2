"""Dataset registration dispatch + evaluator factory (port of
unit_tpu/data/utils.py).  ``register_datasets`` dispatches on
DATASETS.FEWSHOT.TYPE (VOC, COCO and the COCO note and dock suites);
``get_evaluator`` returns a dataset's evaluator by its ``evaluator_type``:
PASCAL VOC, or COCO bbox (plus segm under MODEL.MASK_ON).
"""

from __future__ import annotations

from typing import Optional

from ..evaluation.coco_eval import COCOEvaluator
from ..evaluation.voc_eval import PascalVOCEvaluator
from .catalog import MetadataCatalog


def register_datasets(cfg, devkit_root: Optional[str] = None):
    ds_type = cfg.DATASETS.FEWSHOT.TYPE
    if ds_type in ("VOC", "VOC2007"):
        from .voc import RegisterVOC

        RegisterVOC(cfg, devkit_root).register_all()
    elif ds_type in ("COCO", "COCO_NOTE", "COCO_DOCK"):
        from . import coco

        suite = {"COCO": coco.RegisterCOCO, "COCO_NOTE": coco.RegisterCOCONote,
                 "COCO_DOCK": coco.RegisterCOCODock}[ds_type]
        suite(cfg, devkit_root).register_all()
    else:
        raise ValueError(f"Unknown FEWSHOT.TYPE: {ds_type}")


def get_evaluator(cfg, dataset_name: str):
    meta = MetadataCatalog.get(dataset_name)
    ev_type = meta.get("evaluator_type", "pascal_voc")
    if ev_type == "pascal_voc":
        return PascalVOCEvaluator(
            class_names=meta.get("thing_classes"),
            novel_class_ids=cfg.DATASETS.FEWSHOT.NOVEL_CLASSES_ID,
            use_07_metric=int(meta.get("year", 2007)) == 2007,
        )
    if ev_type == "coco":
        def coco(iou_type):
            return COCOEvaluator(class_names=meta.get("thing_classes"),
                                 novel_class_ids=cfg.DATASETS.FEWSHOT.NOVEL_CLASSES_ID,
                                 iou_type=iou_type)

        if not cfg.MODEL.MASK_ON:
            return coco("bbox")
        return MultiEvaluator([coco("bbox"), coco("segm")])
    raise ValueError(f"Unknown evaluator type {ev_type} for {dataset_name}")


class MultiEvaluator:
    """Fan-out to several evaluators (bbox + segm, like the reference's
    COCOEvaluator with both iou types)."""

    def __init__(self, evaluators):
        self.evaluators = evaluators

    def reset(self):
        for e in self.evaluators:
            e.reset()

    def process_gt_record(self, record):
        for e in self.evaluators:
            e.process_gt_record(record)

    def process(self, *args, **kwargs):
        for e in self.evaluators:
            e.process(*args, **kwargs)

    def merge_from(self, other: "MultiEvaluator"):
        for e, o in zip(self.evaluators, other.evaluators):
            e.merge_from(o)

    def evaluate(self):
        out = {}
        for e in self.evaluators:
            out.update(e.evaluate())
        return out
