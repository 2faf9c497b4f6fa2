"""Profiling on torch.profiler: a trace context manager for an ad-hoc capture,
a trainer hook that captures a window of steps, and the reading of a trace.

Port of unit_tpu/utils/profiling.py.  ``trace`` and ``ProfileHook`` record
CPU activity, and CUDA activity where a card is present, and write one
Chrome trace (``<logdir>/<host>.<pid>.<ns>.pt.trace.json``: chrome://tracing,
Perfetto or TensorBoard's PyTorch profiler plugin read it).  unit_tpu's
``start_server`` (jax.profiler's live-profiling server) has no torch.profiler
counterpart and needs none: the traces are files.

``annotate`` opens a ``record_function`` range named ``unit:<subsystem>``
around each top-level part of a WSRCNN while a trace is taken (the package
itself carries no ranges), and ``summarize_trace`` reads a trace back (the
counterpart of scripts/analyze_trace.py): the device time by kernel, by
kind (``KERNEL_KINDS``) and by subsystem split forward / backward, and the
device's busy share of the traced window.  A backward kernel is charged to
the subsystem of the forward op that made its autograd node: the profiler
records the node's ``Sequence number`` on both, and on the backward one a
non-zero ``Fwd thread id``.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import logging
import os
import socket
import time
from typing import Dict, Iterable, Optional, Tuple

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
    (TPU.PROFILE_START_STEP, TPU.PROFILE_NUM_STEPS).  It reads no loss, so it
    takes a step's losses in flight."""

    takes_lazy_metrics = True

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


# Kernel names -> the kind of work, first match wins (chip_smoke.py's
# profiled breakdowns and summarize_trace)
KERNEL_KINDS = (
    ("K1 roi_align_fwd", ("roi_align_fwd",)),
    ("K2 roi_align_bwd", ("roi_align_bwd",)),
    ("K3 nms_mask", ("nms_survivor",)),
    ("K4 bn_act", ("bn_act",)),
    ("cuDNN conv", ("xmma", "implicit_gemm", "cudnn", "conv2d")),
    ("cuBLAS matmul", ("nvjet", "gemm", "cutlass")),
    ("copies", ("Memcpy", "Memset", "copy")),
    ("sort/scan/index", ("sort", "Sort", "scan", "index", "gather", "scatter")),
    ("elementwise/reduce", ("elementwise", "reduce", "Reduce", "foreach")),
)


def kernel_kind(name: str) -> str:
    """The KERNEL_KINDS kind of a device event's name, else "other"."""
    return next((k for k, frags in KERNEL_KINDS if any(f in name for f in frags)), "other")


# top-level WSRCNN parts -> subsystem; the other children are named as such
_MODULE_SUBSYSTEM = {"backbone": "backbone", "rpn_head": "rpn", "box_head": "box_heads",
                     "weak_box_head": "box_heads", "supervised": "predictors",
                     "weak_detector": "predictors"}
# WSRCNN methods -> subsystem: the RPN's proposal selection (K3), the ROI
# pooler (K1, K2), and the rest of the train losses (matching, sampling,
# the loss terms)
_METHOD_SUBSYSTEM = {"_train_proposals": "rpn", "_test_proposals": "rpn",
                     "pooled_rois": "roi_pooling", "train_losses": "losses_sampling"}
RANGE_PREFIX = "unit:"
STEP_RANGE = RANGE_PREFIX + "step"


def annotated(fn, subsystem: str):
    """``fn`` inside a ``unit:<subsystem>`` range."""
    name = RANGE_PREFIX + subsystem

    def wrapper(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)

    return wrapper


@contextlib.contextmanager
def annotate(model: torch.nn.Module):
    """Ranges around ``model``'s top-level parts while the block runs: its
    child modules (forward pre- and post-hooks) and the methods of
    ``_METHOD_SUBSYSTEM`` (shadowed on the instance); all removed on exit."""
    handles, open_ranges = [], {}
    for child_name, child in model.named_children():
        name = RANGE_PREFIX + _MODULE_SUBSYSTEM.get(child_name, child_name)

        def pre(mod, args, name=name):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_ranges.setdefault(id(mod), []).append(rf)

        def post(mod, args, out):
            open_ranges[id(mod)].pop().__exit__(None, None, None)

        handles.append(child.register_forward_pre_hook(pre))
        handles.append(child.register_forward_hook(post))
    shadowed = [m for m in _METHOD_SUBSYSTEM if hasattr(model, m)]
    for method in shadowed:
        setattr(model, method, annotated(getattr(model, method), _METHOD_SUBSYSTEM[method]))
    try:
        yield model
    finally:
        for h in handles:
            h.remove()
        for method in shadowed:
            delattr(model, method)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _load_events(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _nest(events) -> Dict[int, Optional[dict]]:
    """The innermost enclosing event of each event of one thread, by
    interval containment (id(event) -> parent event or None)."""
    parent, stack = {}, []
    for e in sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0))):
        end = e["ts"] + e.get("dur", 0)
        while stack and stack[-1][1] < end:
            stack.pop()
        parent[id(e)] = stack[-1][0] if stack else None
        stack.append((e, end))
    return parent


def _union_ms(intervals: Iterable[Tuple[float, float]]) -> float:
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e3


def summarize_trace(path: str, top: int = 40) -> dict:
    """Read a torch.profiler Chrome trace (``.json`` or ``.json.gz``):

    device_ms, device_events  the kernels, copies and fills on the device
    window_ms                 first to last event of the trace, any kind
    busy_ms, busy_share       the union of the device events' intervals, and
                              its share of the window
    steps                     ``unit:step`` ranges (1 if none)
    top                       [(name, ms, count)] by device time
    by_kind                   device ms by ``kernel_kind``
    by_subsystem              device ms by ``<subsystem> fwd|bwd``,
                              "optimizer" (ranges ``unit:optimizer`` and
                              ``Optimizer.*``) and "other"
    host_by_subsystem         the same split of the host's time in the
                              outermost CPU ops

    ``by_kind`` and ``by_subsystem`` each sum to ``device_ms``."""
    events = [e for e in _load_events(path) if e.get("ph") == "X" and "ts" in e]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
    threads = collections.defaultdict(list)
    for e in host:
        threads[(e.get("pid"), e.get("tid"))].append(e)
    parent = {}
    for evs in threads.values():
        parent.update(_nest(evs))
    ops_by_ext = {}
    seq_fwd = {}
    for e in sorted(host, key=lambda e: e["ts"]):
        if e.get("cat") != "cpu_op":
            continue
        a = e.get("args") or {}
        if "External id" in a:
            ops_by_ext.setdefault(a["External id"], e)
        if "Sequence number" in a and not a.get("Fwd thread id"):
            # every op records the number the next autograd node will take;
            # the last one before the number moves on made that node
            seq_fwd[a["Sequence number"]] = e

    def ancestors(e):
        while e is not None:
            yield e
            e = parent.get(id(e))

    def range_of(e) -> Optional[str]:
        for a in ancestors(e):
            if a.get("cat") != "user_annotation":
                continue
            name = a.get("name", "")
            if name.startswith("Optimizer.") or name == RANGE_PREFIX + "optimizer":
                return "optimizer"
            if name.startswith(RANGE_PREFIX) and name != STEP_RANGE:
                return name[len(RANGE_PREFIX):]
        return None

    def subsystem(op) -> str:
        if op is None:
            return "other"
        for a in ancestors(op):
            args = a.get("args") or {}
            if a.get("cat") == "cpu_op" and args.get("Fwd thread id"):
                fwd = seq_fwd.get(args.get("Sequence number"))
                sub = range_of(fwd) if fwd is not None else None
                if sub == "optimizer":
                    return sub
                return f"{sub} bwd" if sub else "other"
        sub = range_of(op)
        if sub is None:
            return "other"
        return sub if sub == "optimizer" else f"{sub} fwd"

    ms = collections.Counter()
    count = collections.Counter()
    by_kind = collections.Counter()
    by_sub = collections.Counter()
    for e in device:
        d = e.get("dur", 0) / 1e3
        name = e.get("name", "")
        ms[name] += d
        count[name] += 1
        by_kind[kernel_kind(name)] += d
        op = ops_by_ext.get((e.get("args") or {}).get("External id"))
        by_sub[subsystem(op)] += d
    host_by_sub = collections.Counter()
    for e in host:
        if e.get("cat") == "cpu_op" and not any(
                a.get("cat") == "cpu_op" for a in list(ancestors(e))[1:]):
            host_by_sub[subsystem(e)] += e.get("dur", 0) / 1e3
    starts = [e["ts"] for e in events]
    ends = [e["ts"] + e.get("dur", 0) for e in events]
    window = (max(ends) - min(starts)) / 1e3 if events else 0.0
    busy = _union_ms((e["ts"], e["ts"] + e.get("dur", 0)) for e in device)
    steps = sum(1 for e in host if e.get("name") == STEP_RANGE) or 1
    return {
        "path": path,
        "device_ms": sum(ms.values()),
        "device_events": sum(count.values()),
        "window_ms": window,
        "busy_ms": busy,
        "busy_share": busy / window if window else 0.0,
        "steps": steps,
        "top": [(n, v, count[n]) for n, v in ms.most_common(top)],
        "by_kind": dict(by_kind.most_common()),
        "by_subsystem": dict(by_sub.most_common()),
        "host_by_subsystem": dict(host_by_sub.most_common()),
    }


def newest_trace(logdir: str) -> str:
    """The newest ``*.pt.trace.json[.gz]`` under ``logdir`` (recursively)."""
    found = []
    for root, _, files in os.walk(logdir):
        found += [os.path.join(root, f) for f in files
                  if f.endswith((".pt.trace.json", ".pt.trace.json.gz"))]
    if not found:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    return max(found, key=os.path.getmtime)
