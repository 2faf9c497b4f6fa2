#!/usr/bin/env python3
"""Inference throughput of the flagship detector of unit_tpu_torch on one GPU.

The twin of scripts/bench_eval.py: the batched non-TTA predict path
(TPU.EVAL_BATCH_SIZE; the reference is batch 1 only) at batch 1 and 4 on
the 800x1344 canvas, and with ``--tta`` the test-time augmentation protocol
(TEST.AUG at its defaults: 5 scales x flip = 10 variants on tight per-scale
canvases, each scale's flip pair one batch-2 pass) per image of 600x800.
Seeded random weights with FrozenBN calibrated as chip_smoke.py does (random
statistics give no proposals); the TTA image's host preparation (the numpy
resizes of build_tta_test_loader) is timed apart from its forward.

    python3 scripts/bench_eval_torch.py [--iters 20] [--tta] [--tta-topk K]
        [--fold-bn] [--depth 50|101] [--trace DIR] [--device cuda|cpu]

Every time is host clock around calls that end in the evaluator's packed
device-to-host copy.  Runs on the card unless ``--device cpu`` is given.
The last line is one JSON object with the numbers.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--tta", action="store_true",
                    help="also time the TTA protocol (TEST.AUG defaults) per image")
    ap.add_argument("--tta-topk", type=int, default=0,
                    help="re-score only the top-K canonical proposals (TPU.TTA_PROPOSAL_TOPK; "
                         "0 = all, the reference protocol)")
    ap.add_argument("--fold-bn", action="store_true",
                    help="fold FrozenBN into the convolutions first (TPU.FOLD_BN_AT_EVAL)")
    ap.add_argument("--depth", type=int, default=101, choices=(50, 101))
    ap.add_argument("--trace", default="",
                    help="write a torch.profiler trace of the timed loop (the TTA one with "
                         "--tta) to this directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import contextlib

    import numpy as np
    import torch

    from microbench_torch import chip_smoke_here
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.engine.predict import make_predict_fn, make_tta_predict_fn
    from unit_tpu_torch.engine.runner import resolve_device
    from unit_tpu_torch.evaluation.evaluator import _start_fetch
    from unit_tpu_torch.utils.bn_fold import fold_frozen_bn
    from unit_tpu_torch.utils.profiling import trace

    dev = resolve_device(args.device)
    cs = chip_smoke_here()
    cfg = get_cfg()
    cfg.merge_from_file(str(cs.FLAGSHIP))
    cfg.MODEL.RESNETS.DEPTH = args.depth
    cfg.TEST.AUG.ENABLED = True
    model = cs.flagship_model(cfg, args.seed, dev)
    if args.fold_bn:
        model = fold_frozen_bn(model)
        print("FrozenBN folded into the convolutions (the evaluation-only transform)")

    def fetched(dets):
        host, _, event = _start_fetch(dets)
        if event is not None:
            event.synchronize()
        return host

    def timed(fn, iters):
        fetched(fn())  # warm-up: cuDNN picks its algorithms
        t0 = time.perf_counter()
        for _ in range(iters):
            fetched(fn())
        return (time.perf_counter() - t0) / iters

    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "depth": args.depth, "fold_bn": args.fold_bn}
    rng = np.random.RandomState(args.seed)
    predict = make_predict_fn(model)
    h, w = 800, 1344
    for b in args.batches:
        images = rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
        sizes = np.asarray([[h, w]] * b, np.float32)
        tracing = trace(args.trace) if args.trace and not args.tta else contextlib.nullcontext()
        with tracing:
            per_batch = timed(lambda: predict(images, sizes), args.iters)
        ips = b / per_batch
        out[f"batch{b}_ms"] = per_batch * 1e3
        out[f"batch{b}_images_per_s"] = ips
        print(f"eval batch {b}: {ips:.2f} img/s ({1000.0 / ips:.1f} s per 1k images, "
              f"{per_batch * 1e3:.1f} ms/batch)")

    if args.tta:
        batch, host_ms = cs.tta_batch(cfg, args.seed)
        host_ms = min(host_ms, *(cs.tta_batch(cfg, args.seed)[1] for _ in range(2)))
        tta = make_tta_predict_fn(model, tta_topk=args.tta_topk)
        iters = max(1, args.iters // 2)
        tracing = trace(args.trace) if args.trace else contextlib.nullcontext()
        with tracing:
            per_image = timed(lambda: tta(batch), iters)
        n = len(batch["variants"])
        out.update(tta_s_per_image=per_image, tta_host_prep_s=host_ms / 1e3,
                   tta_variants=n, tta_topk=args.tta_topk)
        print(f"TTA ({n} variants, grouped flip pairs, tight canvases, "
              f"topk={args.tta_topk or 'all'}): {per_image:.3f} s/img ({1.0 / per_image:.2f} "
              f"img/s) of upload and forward; host preparation {host_ms / 1e3:.3f} s/img "
              f"({n + 1} numpy resizes)")
    if args.trace:
        print(f"trace written under {os.path.abspath(args.trace)}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
