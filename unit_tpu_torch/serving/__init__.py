"""Serving (port of unit_tpu.serving: the in-process DetectionService)."""

from .server import DetectionService

__all__ = ["DetectionService"]
