#!/usr/bin/env python3
"""Times K4 (the fused FrozenBN + residual + ReLU epilogue of unit_tpu_torch)
on the card and compares checkouts of the repo within one run.

    python3 scripts/bench_k4_torch.py [--tree DIR] [--train]
    python3 scripts/bench_k4_torch.py --compare PARENT_DIR [DIR ...] [--train] [--out FILE]

(the parts it shares with bench_k{1,2,3}_torch.py are in microbench_torch.py)

Shapes [N, H, W, C], NHWC-dense, forward and backward:
  stem  [1,400,672,64]    the stem's epilogue on an 800x1344 canvas, ReLU
  res4  [4,50,84,1024]    res4's conv3 epilogue at a train step's 4 images,
                          with its residual and ReLU (the kernels line's row)
  res5  [1024,7,7,2048]   Res5's conv3 epilogue over a request's 1000 ROIs
                          (1024 here), with its residual and ReLU
Each shape is first held bit-identical to the plain version (forward and
backward, f32 and bf16; chip_smoke.k4_case), then timed in bf16 with
``cuda_ms_queued`` (device ms of queued launches: a call costs the host more
than the kernel takes) beside the plain version, the four-op chain it
replaces and the bound of the bytes it must move (each input read once,
each output written once, at 3.35 TB/s).  ``--train`` also runs chip_smoke's
phase 7.  Every run prints its log and, last, one line ``K4BENCH {json}``;
``--compare`` runs this script in each DIR, here, here and in each DIR
again, one process each, on one card in one run.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from microbench_torch import chip_smoke_here, compare, load_tree, parser, run_phase  # noqa: E402

SHAPES = {
    "stem": ((1, 400, 672, 64), (False, True)),
    "res4": ((4, 50, 84, 1024), (True, True)),
    "res5": ((1024, 7, 7, 2048), (True, True)),
}


def bench(tree: Path, train: bool):
    cs = load_tree(tree)
    inputs = chip_smoke_here()
    card = cs.phase_env()
    cs.phase_build()
    rng = np.random.RandomState(0)
    result = {"tree": str(tree), "card": card, "cases": {}}
    for name, (shape, (has_res, relu)) in SHAPES.items():
        result["cases"][name] = inputs.k4_case(rng, shape, has_res, relu, tag="[k4]")
    if train:
        result["train"] = run_phase(cs, "train")
    print("K4BENCH " + json.dumps(result), flush=True)


def summarise(rows):
    for row in rows:
        print(row["tree"], row["card"])
        for name, v in row["cases"].items():
            print(f"  {name}: forward {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, chain "
                  f"{v['chain_ms']:.4f}, bound {v['bound_ms']:.4f}), backward "
                  f"{v['bwd_ms']:.4f} ms (plain {v['bwd_plain_ms']:.4f}, bound "
                  f"{v['bwd_bound_ms']:.4f})")
        if "train" in row:
            v = row["train"]
            print(f"  train: medians {v.get('medians_ms')}, kernel time {v.get('kernel_ms')} "
                  f"ms, K4 {v.get('kernel_ms_by_kind', {}).get('K4 bn_act')} ms")


def main():
    args = parser(__doc__.splitlines()[0]).parse_args()
    if args.compare is not None:
        summarise(compare(Path(__file__).resolve(), "K4BENCH", args.compare,
                          ["--train"] if args.train else [], args.out and args.out.resolve()))
    else:
        bench(args.tree.resolve(), args.train)


if __name__ == "__main__":
    main()
