"""The detector's modules (port of unit_tpu.models, serving path)."""

from .meta_arch import WSRCNN, ModelConfig

__all__ = ["ModelConfig", "WSRCNN"]
