"""Entry points around the model (port of unit_tpu.engine: predict, train
and the CLI runner in ``engine.runner``)."""

from .predict import make_predict_fn
from .train import (
    Trainer,
    TrainerBase,
    TrainerFineTune,
    TrainerNoMeta,
    TrainerOnlyWeak,
    TrainerOnlyWeakFineTune,
    TrainState,
    make_pipeline_train_step,
    make_train_step,
)

__all__ = ["TrainState", "Trainer", "TrainerBase", "TrainerFineTune", "TrainerNoMeta",
           "TrainerOnlyWeak", "TrainerOnlyWeakFineTune", "make_pipeline_train_step",
           "make_predict_fn", "make_train_step"]
