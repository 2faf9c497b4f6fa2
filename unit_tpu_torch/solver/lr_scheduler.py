"""Extra LR schedules (port of unit_tpu/solver/lr_scheduler.py).

``cyclic_cosine_decay`` is the reference's ``CyclicCosineDecayLR``: an
initial cosine decay, then fixed-length (or geometrically growing) cosine
restart cycles, optionally after a cosine warm-up.  No shipped config selects
it, and, as in unit_tpu, ``build_optimizer`` does not wire it in: it is a
plain function of the number of updates done, so ``LambdaLR(optimizer,
lambda k: schedule(k) / base_lr)`` runs it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional


def cyclic_cosine_decay(
    base_lr: float,
    init_decay_epochs: int,
    min_decay_lr: float,
    restart_interval: Optional[int] = None,
    restart_interval_multiplier: Optional[float] = None,
    restart_lr: Optional[float] = None,
    warmup_epochs: Optional[int] = None,
    warmup_start_lr: Optional[float] = None,
) -> Callable[[int], float]:
    """The learning rate after ``count`` updates, as unit_tpu's schedule
    computes it (in float64 here, in float32 there)."""

    def cos_interp(start, end, frac):
        return end + (start - end) * (1 + math.cos(math.pi * frac)) / 2

    warmup = warmup_epochs or 0

    def schedule(count: int) -> float:
        it = float(count)
        if it < warmup:
            return cos_interp(warmup_start_lr or 0.0, base_lr, 1.0 - it / max(warmup, 1))
        t = max(it - warmup, 0.0)
        main_lr = cos_interp(base_lr, min_decay_lr, min(max(t / init_decay_epochs, 0.0), 1.0))
        if restart_interval is None:
            return main_lr
        tr = t - init_decay_epochs
        if tr < 0:
            return main_lr
        r_lr0 = restart_lr if restart_lr is not None else base_lr
        if restart_interval_multiplier is None:
            frac = (tr % restart_interval) / restart_interval
        else:
            # geometric cycles: the cycle index in closed form
            m = restart_interval_multiplier
            cyc = math.floor(math.log(max(tr * (m - 1) / restart_interval + 1, 1.0))
                             / math.log(m + 1e-9))
            start = restart_interval * (m ** cyc - 1) / (m - 1)
            length = restart_interval * m ** cyc
            frac = min(max((tr - start) / length, 0.0), 1.0)
        return cos_interp(r_lr0, min_decay_lr, frac)

    return schedule
