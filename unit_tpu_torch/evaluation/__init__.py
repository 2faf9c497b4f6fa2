"""Evaluation: the inference loop and the PASCAL VOC evaluator."""

from .evaluator import inference_loop, inference_on_dataset, inference_on_dataset_meta
from .voc_eval import PascalVOCEvaluator, eval_class, voc_ap

__all__ = ["PascalVOCEvaluator", "eval_class", "inference_loop", "inference_on_dataset",
           "inference_on_dataset_meta", "voc_ap"]
