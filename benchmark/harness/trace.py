"""The traced window: ``torch.profiler`` over a fixed count of steady steps
or calls, and the reading of its Chrome trace.

The reading is a frozen copy of ``unit_tpu_torch/utils/profiling.py``'s
``summarize_trace`` arithmetic (the union of device intervals for the busy
time; a backward kernel charged to the ranges of the forward op that made
its autograd node, by the ``Sequence number`` both record), changed in one
way: a device event counts towards every ``unit:`` range around its op, not
only the innermost, so that a range (the backbone) keeps the time of the
ranges inside it (its FrozenBN epilogues)."""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .probes import RANGE_PREFIX

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_RANGE = RANGE_PREFIX + "step"


class Tracer:
    """``start()`` / ``stop()`` a CPU + CUDA profile; ``stop`` synchronises,
    writes the trace under ``directory`` and returns its path."""

    def __init__(self, directory: str):
        self.directory = directory
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> str:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, "window.pt.trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        return path


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _nest(events) -> Dict[int, Optional[dict]]:
    """The innermost enclosing event of each event of one thread."""
    parent, stack = {}, []
    for e in sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0))):
        end = e["ts"] + e.get("dur", 0)
        while stack and stack[-1][1] < end:
            stack.pop()
        parent[id(e)] = stack[-1][0] if stack else None
        stack.append((e, end))
    return parent


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def summarize(path: str, top: int = 10) -> dict:
    """A trace's numbers, times in seconds:

    window_s, busy_s     first to last event of any kind; the union of the
                         device events' intervals
    steps                ``unit:step`` ranges
    ranges               device seconds by ``<range> fwd|bwd``, a device
                         event counting towards every ``unit:`` range
                         around its op (backward: around the forward op)
    device_ops           [(name, seconds)] of the device events, the top
    idle_gaps            [(what the host was in, seconds)] of the time no
                         device event ran, by the innermost op or range of
                         the launching thread at the gap's start, the top"""
    events = [e for e in load_events(path) if e.get("ph") == "X" and "ts" in e]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
    threads = collections.defaultdict(list)
    for e in host:
        threads[(e.get("pid"), e.get("tid"))].append(e)
    parent = {}
    for evs in threads.values():
        parent.update(_nest(evs))
    ops_by_ext, seq_fwd = {}, {}
    for e in sorted(host, key=lambda e: e["ts"]):
        if e.get("cat") != "cpu_op":
            continue
        a = e.get("args") or {}
        if "External id" in a:
            ops_by_ext.setdefault(a["External id"], e)
        if "Sequence number" in a and not a.get("Fwd thread id"):
            seq_fwd[a["Sequence number"]] = e

    def ancestors(e):
        while e is not None:
            yield e
            e = parent.get(id(e))

    def ranges_of(e) -> set:
        return {a["name"][len(RANGE_PREFIX):] for a in ancestors(e)
                if a.get("cat") == "user_annotation"
                and a.get("name", "").startswith(RANGE_PREFIX) and a["name"] != STEP_RANGE}

    def charged(op) -> Tuple[set, str]:
        if op is None:
            return set(), "fwd"
        for a in ancestors(op):
            args = a.get("args") or {}
            if a.get("cat") == "cpu_op" and args.get("Fwd thread id"):
                fwd = seq_fwd.get(args.get("Sequence number"))
                return (ranges_of(fwd) if fwd is not None else set()), "bwd"
        return ranges_of(op), "fwd"

    by_range = collections.Counter()
    by_name = collections.Counter()
    launches = collections.Counter()
    for e in device:
        d = e.get("dur", 0) / 1e6
        by_name[e.get("name", "")] += d
        op = ops_by_ext.get((e.get("args") or {}).get("External id"))
        if op is not None:
            launches[(op.get("pid"), op.get("tid"))] += 1
        names, way = charged(op)
        for n in names:
            by_range[f"{n} {way}"] += d
    starts = [e["ts"] for e in events]
    ends = [e["ts"] + e.get("dur", 0) for e in events]
    t0, t1 = (min(starts), max(ends)) if events else (0.0, 0.0)
    busy = merged((e["ts"], e["ts"] + e.get("dur", 0)) for e in device)
    busy_us = sum(b - a for a, b in busy)
    # the idle gaps, named by the launching thread's innermost op at each start
    main = launches.most_common(1)[0][0] if launches else None
    main_ops = sorted(threads.get(main, []), key=lambda e: e["ts"])
    gaps, cursor = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    main_starts = [e["ts"] for e in main_ops]
    idle = collections.Counter()
    for a, b in gaps:
        # the last op to start by ``a``, or the innermost of its enclosing
        # ops that still runs at ``a``: ops of one thread nest
        i = bisect.bisect_right(main_starts, a) - 1
        e = main_ops[i] if i >= 0 else None
        while e is not None and not a < e["ts"] + e.get("dur", 0):
            e = parent.get(id(e))
        idle[e["name"] if e is not None else "host: none"] += (b - a) / 1e6
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy_us / 1e6,
        "steps": sum(1 for e in host if e.get("name") == STEP_RANGE),
        "ranges": dict(by_range),
        "device_ops": [[n, v] for n, v in by_name.most_common(top)],
        "idle_gaps": [[n, v] for n, v in idle.most_common(top)],
        "device_events": len(device),
    }
