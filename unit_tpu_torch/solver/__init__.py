"""The optimizer (port of unit_tpu.solver: SGD, schedule, LR groups, freezing)."""

from .build import (
    Solver,
    build_optimizer,
    is_frozen,
    lr_factor_for,
    modify_for_weak_only,
    warmup_multistep,
)
from .lr_scheduler import cyclic_cosine_decay

__all__ = ["Solver", "build_optimizer", "cyclic_cosine_decay", "is_frozen", "lr_factor_for",
           "modify_for_weak_only", "warmup_multistep"]
