"""Serving and deployment (port of unit_tpu.serving): torch.export artifacts
and the HTTP inference server (see export.py and server.py)."""

from .export import ExportedPredictor, describe, export_predict, load_exported
from .server import DetectionServer, DetectionService

__all__ = [
    "DetectionServer",
    "DetectionService",
    "ExportedPredictor",
    "describe",
    "export_predict",
    "load_exported",
]
