"""Profiling on torch.profiler: a trace context manager for an ad-hoc capture
and a trainer hook that captures a window of steps.

Port of unit_tpu/utils/profiling.py.  Both record CPU activity, and CUDA
activity where a card is present, and write one Chrome trace
(``<logdir>/<host>.<pid>.<ns>.pt.trace.json``: chrome://tracing, Perfetto or
TensorBoard's PyTorch profiler plugin read it).  unit_tpu's ``start_server``
(jax.profiler's live-profiling server) has no torch.profiler counterpart and
is not ported (ROADMAP Queue 1 item 29).
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

logger = logging.getLogger("unit_tpu_torch")


def _start() -> profile:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: profile, logdir: str) -> str:
    """Stop ``prof`` once the device has finished what it traced; write its
    trace under ``logdir`` and return the file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
                                ".pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info("profile trace written to %s", path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the block under ``logdir``."""
    prof = _start()
    try:
        yield prof
    finally:
        _stop(prof, logdir)


class ProfileHook:
    """Trainer hook: trace the steps after ``start`` up to ``start + num_steps``
    (TPU.PROFILE_START_STEP, TPU.PROFILE_NUM_STEPS)."""

    def __init__(self, logdir: str, start: int = 10, num_steps: int = 3):
        self.logdir = logdir
        self.start = start
        self.stop = start + num_steps
        self.path: Optional[str] = None  # the last trace written
        self._prof: Optional[profile] = None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def __call__(self, step: int, metrics: dict, trainer):
        if step == self.start and not self._active:
            self._prof = _start()
        elif step >= self.stop and self._active:
            self.close()

    def close(self):
        """Stop a trace in flight (training may end inside the window)."""
        if self._active:
            prof, self._prof = self._prof, None
            self.path = _stop(prof, self.logdir)
