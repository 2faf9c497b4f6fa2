#!/usr/bin/env python3
"""Summarize a torch.profiler trace of unit_tpu_torch (twin of
scripts/analyze_trace.py):

    python3 scripts/analyze_trace_torch.py LOGDIR [--top 40] [--json FILE]

Reads the newest ``*.pt.trace.json[.gz]`` under LOGDIR (as
profile_train_step_torch.py or the ProfileHook writes them) and prints the
total device time and event count, the device's busy share of the traced
window, the top device ops, the device time by kind (cuDNN, cuBLAS, K1-K4,
copies, elementwise ...) and by subsystem split forward / backward, and the
host's time in its outermost CPU ops by subsystem; the per-step columns
divide by the trace's ``unit:step`` ranges.  The reading is
``unit_tpu_torch.utils.profiling.summarize_trace``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from unit_tpu_torch.utils.profiling import newest_trace, summarize_trace  # noqa: E402


def report(s: dict) -> str:
    steps = s["steps"]
    lines = [
        f"total device time: {s['device_ms']:.3f} ms over {s['device_events']} events "
        f"({s['path']})",
        f"traced window {s['window_ms']:.3f} ms, {steps} step(s); device busy "
        f"{s['busy_ms']:.3f} ms ({100 * s['busy_share']:.1f}% of the window, idle "
        f"{100 - 100 * s['busy_share']:.1f}%)",
    ]
    for name, ms, count in s["top"]:
        lines.append(f"{ms:10.3f} ms  x{count:<5} {name[:110]}")
    for title, table in (("device time by kind", s["by_kind"]),
                         ("device time by subsystem", s["by_subsystem"]),
                         ("host time in outermost CPU ops by subsystem",
                          s["host_by_subsystem"])):
        lines.append(f"\n{title} (total, per step /{steps}):")
        for key, ms in table.items():
            lines.append(f"{ms:10.3f} ms {ms / steps:10.3f} ms  {key}")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logdir")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--json", default=None, help="also write the summary to this file")
    args = ap.parse_args()
    summary = summarize_trace(newest_trace(args.logdir), top=args.top)
    print(report(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
