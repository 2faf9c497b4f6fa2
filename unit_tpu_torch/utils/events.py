"""Metrics storage and writers (port of unit_tpu/utils/events.py).

Scalars accumulated per step (kept in flight until a write), written
periodically to the terminal and to ``metrics.json`` (one JSON line per
write, d2's JSONWriter format), and,
under ``MetricsHook(tensorboard=True)``, to TensorBoard event files in
``<output_dir>/tb``.  Two differences from unit_tpu: the console writer
prints no ETA on its first line (unit_tpu divides a near-zero elapsed time
by one step there and shows a false rate), and under data parallelism only
rank 0 writes (the trainer's metrics are already the ranks' mean); unit_tpu
opens ``metrics.json`` in every process.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

from ..parallel import comm

logger = logging.getLogger("unit_tpu_torch")


class EventStorage:
    def __init__(self, window_size: int = 20):
        self._history = defaultdict(lambda: deque(maxlen=window_size))
        self._latest: Dict[str, float] = {}
        self.iter = 0

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            v = float(v)
            self._history[k].append(v)
            self._latest[k] = v

    def median(self, key: str) -> float:
        vals = sorted(self._history[key])
        return vals[len(vals) // 2] if vals else float("nan")

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)


class JSONWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, step: int, storage: EventStorage):
        rec = {"iteration": step}
        rec.update(storage.latest())
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class ConsoleWriter:
    def __init__(self, max_iter: Optional[int] = None):
        self.max_iter = max_iter
        self._t0: Optional[float] = None
        self._first_step = 0

    def write(self, step: int, storage: EventStorage):
        # The clock starts at the first step THIS writer logs (a resumed run
        # starts at step N), and a rate needs two samples: the first line
        # carries no s/it and no ETA.
        parts = [f"iter {step}"]
        now = time.perf_counter()
        if self._t0 is None:
            self._t0, self._first_step = now, step
        elif step > self._first_step:
            per_it = (now - self._t0) / (step - self._first_step)
            parts.append(f"{per_it:.4g} s/it")
            if self.max_iter:
                parts.append(f"eta {(self.max_iter - step) * per_it / 60:.1f}m")
        for k, v in sorted(storage.latest().items()):
            parts.append(f"{k} {storage.median(k):.4g}")
        logger.info("  ".join(parts))


def print_csv_format(results: Dict, logger_=None):
    """CSV-style result dump (engine/defaults.py:243-244 parity): one
    `task,metric,value` line per metric, copy-paste friendly."""
    log = (logger_ or logger).info
    for task, metrics in results.items():
        if not isinstance(metrics, dict):
            log("%s,%s", task, metrics)
            continue
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                log("csv: %s,%s,%.4f", task, k, v)


class TensorBoardWriter:
    """TensorBoard scalars (d2's PeriodicWriter); a writer that writes
    nothing when ``torch.utils.tensorboard`` does not import (the
    ``tensorboard`` package is optional), as in unit_tpu."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.warning("torch.utils.tensorboard does not import: no TensorBoard events")
            self._w = None
        else:
            self._w = SummaryWriter(logdir)

    def write(self, step: int, storage: EventStorage):
        if self._w is None:
            return
        for k, v in storage.latest().items():
            self._w.add_scalar(k, v, step)

    def close(self):
        if self._w is not None:
            self._w.close()


class MetricsHook:
    """Trainer hook: accumulate every step's metrics, write every ``period``
    (also to TensorBoard under ``tensorboard``); on rank 0 only.  It takes a
    step's losses in flight (``engine.train.LazyMetrics``) and keeps them
    until the write, as unit_tpu's does: the window then resolves at once,
    with the same values in the same order as step by step."""

    takes_lazy_metrics = True

    def __init__(self, output_dir: str, period: int = 20, max_iter: Optional[int] = None,
                 tensorboard: bool = False, lr_fn=None):
        self.storage = EventStorage()
        self.period = period
        self.lr_fn = lr_fn  # step -> current lr (d2 logs lr per step)
        self._buf: list = []  # (step, metrics) until the write
        self.writers = []
        if comm.is_main():
            self.writers = [
                ConsoleWriter(max_iter),
                JSONWriter(os.path.join(output_dir, "metrics.json")),
            ]
            if tensorboard:
                self.writers.append(TensorBoardWriter(os.path.join(output_dir, "tb")))

    def __call__(self, step: int, metrics: dict, trainer):
        self._buf.append((step, metrics))
        if step % self.period == 0:
            for s, m in self._buf:
                self.storage.iter = s
                self.storage.put_scalars(**m)
                if self.lr_fn is not None:
                    self.storage.put_scalars(lr=float(self.lr_fn(s)))
            self._buf.clear()
            for w in self.writers:
                w.write(step, self.storage)

    def close(self):
        for w in self.writers:
            if hasattr(w, "close"):
                w.close()
