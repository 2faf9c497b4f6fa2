"""Read a training cell's compared numbers for the program, for the control
and for planted faults, seed by seed, on the card: the readings the limits
in ``benchmark/limits/<cell>.json`` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

For each seed: the program's first steps (as a run's set-up takes them),
then the plain reference at the configuration's precision (bfloat16) on its
own batches from the same state.  Against that reference: the program; the
control (the reference with every convolution's inputs and weights and
every batch norm's output rounded to float8, the precision below the
configuration's); the faults "half of each batch left out" and "every
learning rate 1.3 times the recipe's"; the reference run a second time
(what its own run-to-run differences read); and the reference with every
trainable element moved one float32 step after its first update (what a
rounding-level difference after step 1 reads by step 3).  A state left unchanged reads
1 on every change number by its definition and is not run.  Besides, how
many of the ROIs the box head sampled and of OICR's pseudo boxes differ
between the program and the reference at each step (``flips``: the
program's are read by wrapping its sampler and its pseudo-box miner for
the checked steps).  One JSON line a seed on standard output."""

import argparse
import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(BENCH, "reference"), ROOT):
    if p not in sys.path:
        sys.path.insert(1, p)

FAULTS = (("control", {"fp8": True}), ("half", {"drop_half": True}),
          ("lr_x1.3", {"lr_scale": 1.3}), ("reference_again", {}),
          ("reference_nudged", {"nudge": True}))


def program_picks():
    """Wrap the program's sampler and pseudo-box miner: (what they pick,
    undo)."""
    from unit_tpu_torch.models import weak_losses
    from unit_tpu_torch.ops import sampling

    seen = {"sampled": [], "pseudo": []}
    orig_sample, orig_mine = sampling.label_and_sample_proposals, weak_losses.mine_pseudo_gt

    def sample(*a, **kw):
        out = orig_sample(*a, **kw)
        seen["sampled"].append(out.boxes[out.valid].detach().cpu())
        return out

    def mine(*a, **kw):
        out = orig_mine(*a, **kw)
        for b, v in zip(out.boxes, out.valid):
            seen["pseudo"].append(b[v].detach().cpu())
        return out

    sampling.label_and_sample_proposals, weak_losses.mine_pseudo_gt = sample, mine

    def undo():
        sampling.label_and_sample_proposals, weak_losses.mine_pseudo_gt = orig_sample, orig_mine

    return seen, undo


def flips(prog: dict, ref: list, steps: int) -> dict:
    """Per step, the sampled ROIs and the pseudo boxes (of every image and
    OICR stage) that differ by more than 1e-3 pixels, and their totals."""
    out = {}
    for key in ("sampled", "pseudo"):
        per = len(prog[key]) // steps
        counts = []
        for k in range(steps):
            mine, theirs = prog[key][k * per:(k + 1) * per], ref[k][key]
            n = 0
            for a, b in zip(mine, theirs):
                if a.shape != b.shape:
                    n += max(len(a), len(b))
                else:
                    n += int(((a - b).abs().amax(-1) > 1e-3).sum())
            counts.append([n, sum(len(b) for b in theirs)])
        out[key] = counts
    return out


def readings(cell, seed: int, dev) -> dict:
    import gc

    from harness import common, train, traffic

    work = traffic.scratch_dir("control")
    picks, undo = program_picks()
    try:
        try:
            s = train.set_up(cell, seed, dev, work)
        finally:
            undo()
        s["trainer"].close()
        del s["trainer"], s["model"]
        gc.collect()
        common.empty_cache(dev)
        r = float(cell.mix["round_off"])
        batches, gaps = train.reference_batches(cell, s, dev)
        seen = []
        ref = train.check(cell, s, dev, batches, record=seen)
        out = {"program": dict(train.compare(s["prog"], ref, r), **gaps),
               "program_steps": train.diagnostics(s["prog"], ref),
               "flips": flips(picks, seen, len(batches))}
        common.log(f"[flips] (differing, of) by step: {out['flips']}")
        common.log(f"[program] {train.worst_leaves(s['prog']['grad'], ref['grad'])}")
        for name, fault in FAULTS:
            other = train.check(cell, s, dev, batches, **fault)
            out[name] = train.compare(other, ref, r)
            out[name + "_steps"] = train.diagnostics(other, ref)
            common.log(f"[{name}] {train.worst_leaves(other['grad'], ref['grad'])}")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--only", default="", help="the readings to take besides the program's "
                    "(comma-separated names of FAULTS; all by default)")
    args = ap.parse_args(argv)
    if args.only:
        global FAULTS
        FAULTS = tuple(f for f in FAULTS if f[0] in args.only.split(","))
    import torch

    from harness import common

    cell = common.Cell(common.load_json(ROOT, "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        common.log("no card")
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(v) for v in args.seeds.split(",")):
        out = readings(cell, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
