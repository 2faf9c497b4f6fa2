#!/usr/bin/env python3
"""Times K1 (the ROIAlignV2 forward kernel of unit_tpu_torch) on the card and
compares checkouts of the repo within one run.

    python3 scripts/bench_k1_torch.py [--tree DIR] [--sweep] [--train] [--serve]
    python3 scripts/bench_k1_torch.py --compare PARENT_DIR [DIR ...] [--train] [--serve]

(the parts it shares with bench_k2_torch.py and bench_k3_torch.py are in
microbench_torch.py)

Shapes, P = 14, s = 2: a served request's [1, 50, 84, 1024] x 1000 ROIs
(chip_smoke's ``flagship_rois``) and a train step's [2, 50, 84, 1024] x 512 in
three layouts (``flagship_rois``, ``piled_rois``, ``one_band_rois``), in bf16
and f32.  Each case is first held to chip_smoke's gate against the checkout's
plain version (f32 within K1_F32_ATOL, bf16 within one bf16 ulp beyond it)
and two launches must be bit-identical.  ``--sweep`` also times every bf16
case at each setting of ``roi_align_cuda.FWD_TUNING`` (where the checkout has
it).  ``--train`` and ``--serve`` also run chip_smoke's phases 7 and 4 (step
and request medians, one profiled step and request: kernel time by layer,
device ops).  ``--compare`` runs this script in each DIR, here, here and in
each DIR again, one process each, on one card in one run; a checkout of
another commit is made with ``git archive``.  Every run prints its log and,
last, one line ``K1BENCH {json}``; times are medians of CUDA events in ms, the
wrapper's host time per call in microseconds, bounds as chip_smoke counts them.
"""

import itertools
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from microbench_torch import (  # noqa: E402
    chip_smoke_here,
    compare,
    load_tree,
    measure,
    parser,
    run_phase,
)

MAP = (50, 84, 1024)
P = 14
SWEEP = {"slice": (64, 128, 256, 512), "threads": (64, 128, 256)}
# (name, images, ROIs an image, chip_smoke's ROI generator)
CASES = (
    ("serve_1x1000_flagship", 1, 1000, "flagship_rois"),
    ("train_2x512_flagship", 2, 512, "flagship_rois"),
    ("train_2x512_piled", 2, 512, "piled_rois"),
    ("train_2x512_one_band", 2, 512, "one_band_rois"),
)


def bench(tree: Path, train: bool, serve: bool, sweep: bool = False):
    cs = load_tree(tree)
    import torch

    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.ops import roi_align_cuda as rc

    inputs = chip_smoke_here()
    card = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    tuning = getattr(rc, "FWD_TUNING", None)
    result = {"tree": str(tree), "card": card, "tuning": tuning and dict(tuning), "cases": {}}

    for name, b, n, layout in CASES:
        feat32 = torch.as_tensor(rng.randn(b, *MAP).astype(np.float32), device=dev)
        rois = torch.as_tensor(np.stack([getattr(inputs, layout)(rng, n) for _ in range(b)]),
                               device=dev)
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            feat = feat32.to(dtype)

            def call():
                return rc.roi_align_cuda(feat, rois, P)

            before = rc.roi_align_cuda.launches
            got = call()
            launches = rc.roi_align_cuda.launches - before
            want = ra.roi_align_plain(feat, rois, P).float()
            diff = (got.float() - want).abs()
            tol = inputs.K1_F32_ATOL + (
                torch.maximum(got.float().abs(), want.abs()) * 2.0 ** -7 * inputs.K1_BF16_ULPS
                if dtype == torch.bfloat16 else 0.0)
            ok = bool((diff <= tol).all()) and torch.equal(call(), got)
            out_bytes = got.numel() * got.element_size()
            row = {"ok": ok, "launches": launches, "max_abs_err": float(diff.max()),
                   **inputs.bound(inputs.nbytes(feat, rois) + out_bytes,
                                  got.numel() * inputs.ROI_ALIGN_FLOPS),
                   **measure(cs, call)}
            del want, diff, tol
            cs.log(f"[k1] {name} {tag}: {row}")
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version ({name} {tag})")
            if sweep and tuning is not None and dtype == torch.bfloat16:
                chosen = dict(tuning)
                row["sweep"] = []
                for values in itertools.product(*SWEEP.values()):
                    tuning.update(zip(SWEEP, values))
                    entry = {**dict(zip(SWEEP, values)), "ok": torch.equal(call(), got),
                             "ms": cs.cuda_ms(call, 10)}
                    row["sweep"].append(entry)
                    cs.log(f"[k1] {name} {tag} {entry}")
                tuning.update(chosen)
            result["cases"][f"{name}_{tag}"] = row
            del got, feat
        del feat32
    torch.cuda.empty_cache()
    if train:
        result["train"] = run_phase(cs, "train")
    if serve:
        result["serve"] = run_phase(cs, "serve")
    print("K1BENCH " + json.dumps(result), flush=True)


def summarise(rows):
    for row in rows:
        print(row["tree"], row["card"], row["tuning"])
        for name, v in row["cases"].items():
            print(f"  {name}: {v['ms']:.4f} ms ({v['queued_ms']:.4f} queued), host "
                  f"{v['host_us']:.1f} us, bound {v['bound_ms']:.4f} ms, max|diff| "
                  f"{v['max_abs_err']:.3g}")
        for phase in ("train", "serve"):
            if phase in row:
                v = row[phase]
                print(f"  {phase}: medians {v.get('medians_ms')}, kernel time "
                      f"{v.get('kernel_ms')} ms, {v.get('device_ops')} device ops, K1 "
                      f"{v.get('kernel_ms_by_kind', {}).get('K1 roi_align_fwd')} ms")


def main():
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--serve", action="store_true",
                    help="also chip_smoke's phase 4: the served requests")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every bf16 case at each setting of FWD_TUNING")
    args = ap.parse_args()
    if args.compare is not None:
        flags = (["--train"] if args.train else []) + (["--serve"] if args.serve else [])
        summarise(compare(Path(__file__).resolve(), "K1BENCH", args.compare, flags,
                          args.out and args.out.resolve()))
    else:
        bench(args.tree.resolve(), args.train, args.serve, args.sweep)


if __name__ == "__main__":
    main()
