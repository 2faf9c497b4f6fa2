#!/usr/bin/env python3
"""Times the paths of unit_tpu_torch that launch kernels without a gradient,
and compares checkouts of the repo within one run.

    python3 scripts/bench_nograd_torch.py [--tree DIR] [--iters 8]
    python3 scripts/bench_nograd_torch.py --compare PARENT_DIR [DIR ...] [--out FILE]

(the parts it shares with the kernel benchmarks are in microbench_torch.py)

Paths, each at full width with seeded weights built as chip_smoke.py builds
them (bf16):
  request  the flagship's predict at batch 1 on the 800x1344 canvas
  tta      the flagship's TTA predict of one 600x800 image (10 variants)
  note     the note recipe's predict of a 480x640 image
  dock     the dock recipe's predict of a 480x640 image with 5000 proposals
  meta     one meta train step (2 strong + 2 weak images and 15 x 5 shots),
           whose support stream and detached heads take no gradient
Each call ends in one device-to-host copy of its outputs (a request) or of
its losses (the step).  Per path: the median and least host-clock ms of
``--iters`` calls after two warm-up calls, the kernels' launches a call, and
one call under torch.profiler: wall ms, device busy ms, device ops (kernels
and copies) and CPU-side profiler events (the operators dispatched on the
host, nested ones included).  Every run prints its log and, last, one line
``NOGRAD {json}``; ``--compare`` runs this script in each DIR, here, here and
in each DIR again, one process each, on one card in one run.
"""

import argparse
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from microbench_torch import HERE, chip_smoke_here, compare, load_tree  # noqa: E402

PATHS = ("request", "tta", "note", "dock", "meta")
SEED = 0


def profiled(fn):
    """One fn() under torch.profiler -> wall and device busy ms, device ops
    and CPU-side events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type.name == "CUDA"
              and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)]
    return {"profiled_wall_ms": wall,
            "busy_ms": sum(e.self_device_time_total for e in device) / 1e3,
            "device_ops": sum(e.count for e in device),
            "cpu_events": sum(e.count for e in events if e.device_type.name == "CPU")}


def timed(inputs, fn, iters):
    """Two warm-up calls, then ``iters`` timed ones with the launches they
    make, then one profiled call."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    inputs.reset_launch_counts()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v / iters for k, v in inputs.read_launch_counts().items() if v}
    return {"median_ms": statistics.median(ms), "min_ms": min(ms), "ms": ms,
            "launches_a_call": launches, **profiled(fn)}


def fetched(dets):
    """Wait for the evaluator's packed device-to-host copy of ``dets``."""
    from unit_tpu_torch.evaluation.evaluator import _start_fetch

    host, _, event = _start_fetch(dets)
    if event is not None:
        event.synchronize()
    return host


def recipe(path):
    from unit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(path))
    return cfg


def request_fn(inputs, cfg, dev, shape, proposals=False):
    """A predict call of one seeded image of ``shape`` prepared as the test
    loader prepares it (with its proposal file's top-K under ``proposals``)."""
    import runpy

    from unit_tpu_torch.data.proposals import attach_proposals
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_detection_record
    from unit_tpu_torch.engine.predict import make_predict_fn

    model = inputs.flagship_model(cfg, SEED, dev)
    predict = make_predict_fn(model)
    rng = np.random.RandomState(SEED + 1)
    h, w = shape
    image = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    record = {"image_id": "0", "height": h, "width": w, "annotations": []}
    tcfg = TransformConfig.test_from_cfg(cfg)
    if proposals:
        import os
        import pickle
        import tempfile

        topk = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
        tcfg.proposal_capacity = topk
        writer = runpy.run_path(str(inputs.ROOT / "scripts" / "make_shapes_proposals_torch.py"))
        gt = np.asarray([[40.0, 30.0, 300.0, 260.0]])
        boxes, scores = writer["mcg_like_proposals"](gt, w, h, rng, per_image=topk)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "proposals.pkl")
            with open(path, "wb") as f:
                pickle.dump({"0": {"boxes": boxes, "scores": scores}}, f)
            attach_proposals([record], [path], topk)
    s = prepare_detection_record(record, tcfg, None, image=image, training=False)
    args = [s["image"][None], s["image_size"][None]]
    if proposals:
        args += [s["proposals"][None], s["proposals_valid"][None]]
    return lambda: fetched(predict(*args))


def tta_fn(inputs, cfg, dev):
    from unit_tpu_torch.engine.predict import make_tta_predict_fn

    cfg.TEST.AUG.ENABLED = True
    tta = make_tta_predict_fn(inputs.flagship_model(cfg, SEED, dev))
    batch, _ = inputs.tta_batch(cfg, SEED)
    return lambda: fetched(tta(batch))


def meta_fn(inputs, cfg, dev):
    from unit_tpu_torch.data.loader import pin_batch
    from unit_tpu_torch.engine.train import Trainer
    from unit_tpu_torch.solver import build_optimizer

    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True  # random weights: clipped as chip_smoke's
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    model = inputs.flagship_model(cfg, SEED, dev)
    strong, weak = inputs.synthetic_train_batches(cfg, SEED + 20)
    support = inputs.synthetic_support_batches(cfg, SEED + 21)
    strong, weak, support = ([pin_batch(b) for b in s] for s in (strong, weak, support))
    trainer = Trainer(model, build_optimizer(cfg, model), itertools.cycle(strong),
                      itertools.cycle(weak), meta_iter=itertools.cycle(support), seed=SEED)
    trainer.init_state()
    return trainer.run_step  # ends in one device-to-host copy of the losses


def bench(tree: Path, iters: int):
    cs = load_tree(tree)
    import torch

    inputs = chip_smoke_here()
    card = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda")
    torch.backends.cudnn.deterministic = True
    builders = {
        "request": lambda: request_fn(inputs, recipe(inputs.FLAGSHIP), dev, (800, 1344)),
        "tta": lambda: tta_fn(inputs, recipe(inputs.FLAGSHIP), dev),
        "note": lambda: request_fn(inputs, recipe(inputs.NOTE_RECIPE), dev, (480, 640)),
        "dock": lambda: request_fn(inputs, recipe(inputs.DOCK_RECIPE), dev, (480, 640),
                                   proposals=True),
        "meta": lambda: meta_fn(inputs, recipe(inputs.META_RECIPE), dev),
    }
    out = {"tree": str(tree), "card": card, "iters": iters}
    for name in PATHS:
        fn = builders[name]()
        with torch.inference_mode(name != "meta"):
            row = timed(inputs, fn, iters)
        print(f"{name}: median {row['median_ms']:.2f} ms (least {row['min_ms']:.2f}); "
              f"profiled wall {row['profiled_wall_ms']:.2f} ms, busy {row['busy_ms']:.2f} ms, "
              f"{row['device_ops']} device ops, {row['cpu_events']} CPU events; launches a "
              f"call {row['launches_a_call']}", flush=True)
        out[name] = row
        del fn
        torch.cuda.empty_cache()
    print("NOGRAD " + json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE,
                    help="the checkout to measure (default: this one)")
    ap.add_argument("--compare", type=Path, nargs="+", default=None, metavar="DIR",
                    help="other checkouts to run in turns with this one")
    ap.add_argument("--out", type=Path, default=None, metavar="FILE",
                    help="with --compare: also leave every run's row in this JSON file")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()
    if args.compare:
        flags = ["--iters", str(args.iters)]
        rows = compare(Path(__file__).resolve(), "NOGRAD", args.compare, flags, args.out)
        for name in PATHS:
            print(f"{name}: median ms " + ", ".join(f"{r[name]['median_ms']:.2f}" for r in rows)
                  + "; device ops " + ", ".join(str(r[name]["device_ops"]) for r in rows)
                  + "; CPU events " + ", ".join(str(r[name]["cpu_events"]) for r in rows))
        return
    bench(args.tree, args.iters)


if __name__ == "__main__":
    main()
