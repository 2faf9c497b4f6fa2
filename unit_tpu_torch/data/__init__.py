"""Host-side data: catalogs, VOC registration, transforms and loaders (port of
unit_tpu.data for the VOC suites)."""

from .catalog import DatasetCatalog, MetadataCatalog
from .loader import (
    Prefetcher,
    StreamLoader,
    SupportLoader,
    build_classifier_loader,
    build_classifier_strong_loader,
    build_strong_loader,
    build_support_loader,
    build_test_loader,
    build_tta_test_loader,
    sample_classifier_dataset,
)
from .transforms import TransformConfig, collate, prepare_detection_record
from .voc import RegisterVOC, kshot_sample, load_voc_split, parse_voc_xml

__all__ = [
    "DatasetCatalog", "MetadataCatalog", "Prefetcher", "RegisterVOC", "StreamLoader",
    "SupportLoader", "TransformConfig", "build_classifier_loader",
    "build_classifier_strong_loader", "build_strong_loader", "build_support_loader",
    "build_test_loader", "build_tta_test_loader", "collate", "kshot_sample", "load_voc_split",
    "parse_voc_xml",
    "prepare_detection_record", "sample_classifier_dataset",
]
