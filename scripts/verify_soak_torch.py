#!/usr/bin/env python
"""Verify a recipe-length soak run of the PyTorch/CUDA port
(scripts/run_soak_torch.sh); twin of scripts/verify_soak.py, which reads
orbax's checkpoint layout.  The same checks, messages and exit codes; the
port writes its periodic checkpoints as ``step_<N>.pt`` files
(unit_tpu_torch/checkpoint/checkpointer.py) and logs "resuming from step
<N>" to log.txt on a --resume (unit_tpu_torch/engine/runner.py).

Checks, on the soak OUTPUT_DIR:
  1. metrics.json covers the full schedule (last iteration >= --iters) with a
     contiguous iteration sequence across the SIGTERM/--resume boundary.
  2. The loss curve is continuous at the resume point: the first post-resume
     window's median total_loss is within a tolerance band of the last
     pre-resume window (exact-resume loaders + restored opt state => no jump;
     bit-exactness itself is proven by tests/test_resume_and_preempt.py).
  3. LR step boundaries actually happened: the logged lr drops by ~10x after
     each SOLVER.STEPS boundary.
  4. Checkpoint rotation: at most max_to_keep step_<N>.pt files remain.
  5. best-AP bookkeeping survived the preemption: best_info.json exists,
     carries {AP50, iteration}, and the best/ snapshot dir is present.
"""

import argparse
import json
import os
import re
import sys

STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--steps", type=int, nargs="*", default=[12000, 24000])
    ap.add_argument("--max-to-keep", type=int, default=3)
    args = ap.parse_args()

    recs = []
    with open(os.path.join(args.outdir, "metrics.json")) as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    its = [r["iteration"] for r in recs if "total_loss" in r]
    losses = {r["iteration"]: r["total_loss"] for r in recs if "total_loss" in r}
    lrs = {r["iteration"]: r.get("lr") for r in recs if r.get("lr") is not None}
    ok = True

    # 1. full coverage + contiguity (the writer logs every 20 steps; a resume
    # re-logs from the restored step, so duplicates are fine but gaps are not)
    last = max(its)
    print(f"last iteration logged: {last}")
    if last < args.iters - 20:
        print(f"FAIL: schedule incomplete ({last} < {args.iters})")
        ok = False
    gaps = [
        (a, b) for a, b in zip(sorted(set(its)), sorted(set(its))[1:]) if b - a > 40
    ]
    if gaps:
        print(f"FAIL: iteration gaps across resume: {gaps[:5]}")
        ok = False
    else:
        print("iteration sequence contiguous (no gaps > 2 log periods)")

    # 2. loss continuity at the resume point (read from stage logs if present)
    resume_points = []
    runs_dir = os.path.dirname(os.path.abspath(args.outdir))
    for cand in (os.path.join(runs_dir, "stage2.log"),
                 os.path.join(args.outdir, "log.txt")):
        if os.path.exists(cand):
            with open(cand) as f:
                for line in f:
                    if "resuming from step" in line:
                        resume_points.append(
                            int(line.rsplit("step", 1)[1].split()[0])
                        )
    for resume_at in sorted(set(resume_points)):
        pre = [losses[i] for i in sorted(losses) if resume_at - 400 <= i < resume_at]
        post = [losses[i] for i in sorted(losses) if resume_at <= i < resume_at + 400]
        if pre and post:
            import statistics

            mpre, mpost = statistics.median(pre), statistics.median(post)
            print(f"resume at {resume_at}: median loss pre={mpre:.4f} post={mpost:.4f}")
            if abs(mpost - mpre) > 0.5 * max(mpre, 0.2):
                print("FAIL: loss discontinuity at resume")
                ok = False
        else:
            print(f"WARN: no loss samples around resume point {resume_at}")
    if not resume_points:
        print("WARN: resume step not found in stage2.log / log.txt")

    # 3. LR schedule boundaries
    for b in args.steps:
        before = [lrs[i] for i in sorted(lrs) if b - 400 <= i < b]
        after = [lrs[i] for i in sorted(lrs) if b < i <= b + 400]
        if before and after:
            r = after[-1] / before[0]
            print(f"lr drop at {b}: {before[0]:.2e} -> {after[-1]:.2e} (x{r:.3f})")
            if not (0.05 < r < 0.2):
                print(f"FAIL: lr at step {b} did not drop ~10x")
                ok = False
        else:
            print(f"WARN: no lr samples around boundary {b}")

    # 4. rotation (the port's step_<N>.pt files directly in OUTPUT_DIR)
    steps_kept = [m.group(1) for m in map(STEP_FILE.match, os.listdir(args.outdir))
                  if m and os.path.isfile(os.path.join(args.outdir, m.group(0)))]
    print(f"checkpoints kept: {sorted(int(s) for s in steps_kept)}")
    if not steps_kept:
        print("FAIL: no checkpoint step files found")
        ok = False
    if len(steps_kept) > args.max_to_keep:
        print(f"FAIL: rotation kept {len(steps_kept)} > {args.max_to_keep}")
        ok = False

    # 5. best bookkeeping
    binfo = os.path.join(args.outdir, "best_info.json")
    if os.path.exists(binfo):
        with open(binfo) as f:
            info = json.load(f)
        print(f"best_info: {info}")
        if "AP50" not in info or "iteration" not in info:
            print("FAIL: best_info missing keys")
            ok = False
        best_dir = os.path.join(os.path.dirname(binfo), "best")
        if not os.path.isdir(best_dir):
            print(f"FAIL: best snapshot dir missing at {best_dir}")
            ok = False
    else:
        print("FAIL: best_info.json not found")
        ok = False

    print("SOAK " + ("PASS" if ok else "FAIL"))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
