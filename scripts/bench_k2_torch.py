#!/usr/bin/env python3
"""Times K2 (the ROIAlignV2 backward kernel of unit_tpu_torch) on the card, at
the flagship's train-step shape g [2, 512, 14, 14, 1024] bf16 with uniform and
with piled ROIs, and compares two checkouts of the repo within one run.

    python3 scripts/bench_k2_torch.py [--tree DIR] [--sweep] [--train]
    python3 scripts/bench_k2_torch.py --compare PARENT_DIR [--train]

``--tree`` names the checkout whose ``unit_tpu_torch`` and ``chip_smoke`` are
measured (default: the one this file lies in).  Each layout is checked
against the plain version with chip_smoke's bound first.  ``--sweep`` also
times every setting of ``roi_align_cuda.BWD_TUNING`` (where the checkout has
it).  ``--train`` also runs chip_smoke's phase 7 (the flagship train step:
step medians and one profiled step with its device time by layer).
``--compare`` runs this script in PARENT_DIR, here, here and in PARENT_DIR
again, one process each, so that both are timed on one card in one run; a
checkout of the parent commit is made with ``git archive``.  Every run prints
its log and, last, one line ``K2BENCH {json}``; times are medians of CUDA
events in ms, the wrapper's host time per call in microseconds.
"""

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
SHAPE = (2, 50, 84, 1024)
N_ROIS = 512
SWEEP = {"seg": (32, 64, 128), "warps": (1, 2, 4)}


def measure(cs, fn):
    """Device ms per call (median of 20), and queued device ms and host us."""
    ms = cs.cuda_ms(fn, 20)
    queued_ms, host_ms = cs.cuda_ms_queued(fn, 20)
    return {"ms": ms, "queued_ms": queued_ms, "host_us": 1e3 * host_ms}


def bench(tree: Path, sweep: bool, train: bool):
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.ops import roi_align_cuda as rc

    card = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    b = SHAPE[0]
    layouts = {
        "uniform": np.stack([cs.flagship_rois(rng, N_ROIS) for _ in range(b)]),
        "piled": np.stack([cs.piled_rois(rng, N_ROIS) for _ in range(b)]),
    }
    g = torch.as_tensor(rng.randn(b, N_ROIS, 14, 14, SHAPE[3]).astype(np.float32),
                        device=dev).to(torch.bfloat16)
    result = {"tree": str(tree), "card": card, "layouts": {}}
    tuning = getattr(rc, "BWD_TUNING", None)
    for name, rois_np in layouts.items():
        rois = torch.as_tensor(rois_np, device=dev)

        def call():
            return rc.roi_align_backward_cuda(g, rois, SHAPE)

        got = call().float()
        want = ra.roi_align_backward_plain(g, rois, SHAPE).float()
        s_abs = ra.roi_align_backward_plain(g.float().abs(), rois, SHAPE)
        tol = s_abs * cs.K2_REL + torch.maximum(got.abs(), want.abs()) * 2.0 ** -7
        ok = bool(((got - want).abs() <= tol).all()) and torch.equal(call().float(), got)
        row = {"ok": ok, **measure(cs, call)}
        row["scratch_bytes"] = getattr(rc.roi_align_backward_cuda, "scratch_bytes", None)
        cs.log(f"[k2] {name}: {row}")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version ({name} ROIs)")
        if sweep and tuning is not None:
            keep = dict(tuning)
            row["sweep"] = []
            for values in itertools.product(*SWEEP.values()):
                tuning.update(zip(SWEEP, values))
                again = call().float()  # segments change the order of the sums
                entry = {**dict(zip(SWEEP, values)), "ms": cs.cuda_ms(call, 10),
                         "ok": bool(((again - want).abs() <= tol).all())}
                row["sweep"].append(entry)
                cs.log(f"[k2] {name} {entry}")
            tuning.update(keep)
        del want, s_abs, tol
        result["layouts"][name] = row
    del g
    torch.cuda.empty_cache()
    if train:
        from unit_tpu_torch.config import get_cfg

        cfg = get_cfg()
        cfg.merge_from_file(str(cs.FLAGSHIP))
        result["train_launches"] = cs.phase_train(cfg, 0)
    print("K2BENCH " + json.dumps(result), flush=True)


def compare(parent: Path, train: bool):
    rows = []
    for tree in (parent, HERE, HERE, parent):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--tree", str(tree)]
        proc = subprocess.run(cmd + (["--train"] if train else []), cwd=tree, text=True,
                              capture_output=True)
        print(f"==== {tree} (exit {proc.returncode})\n{proc.stdout}\n{proc.stderr[-3000:]}",
              flush=True)
        if proc.returncode:
            raise SystemExit(proc.returncode)
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1].split(" ", 1)[1]))
    for row in rows:
        print(row["tree"], row["card"], {k: (round(v["ms"], 4), round(v["host_us"], 1),
                                             v["scratch_bytes"])
                                         for k, v in row["layouts"].items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--compare", type=Path, default=None, metavar="PARENT_DIR")
    args = ap.parse_args()
    if args.compare is not None:
        compare(args.compare.resolve(), args.train)
    else:
        bench(args.tree.resolve(), args.sweep, args.train)


if __name__ == "__main__":
    main()
