"""Entry points around the model (port of unit_tpu.engine, predict only)."""

from .predict import make_predict_fn

__all__ = ["make_predict_fn"]
