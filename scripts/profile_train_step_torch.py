#!/usr/bin/env python3
"""Trace train steps (or a TTA image) of unit_tpu_torch with torch.profiler
(twin of scripts/profile_train_step.py).  Pair with analyze_trace_torch.py:

    python3 scripts/profile_train_step_torch.py --out DIR [--path train]
    python3 scripts/analyze_trace_torch.py DIR

Paths, at full width with seeded weights built as chip_smoke.py builds them
(FrozenBN calibrated on a seeded image, GloVe, bf16, gradients clipped to
global norm 1.0: the weights are random):
  train  the flagship recipe's step (TrainerNoMeta), chip_smoke.py phase 7's
         synthetic batches: --batch strong + --batch weak images a step on
         the recipe's largest train canvas, both orientations in turns
  meta   the meta recipe's step (Trainer) with 15 classes x 5 support shots
  dock   the dock recipe's step with precomputed proposals for both streams
  tta    one 600x800 image under the flagship's test-time augmentation
One warm-up step, ``--steady`` more, then ``--steps`` traced, each in a
``unit:step`` range, with ``unit:<subsystem>`` ranges around the model's
parts (``unit_tpu_torch.utils.profiling.annotate``).  The Chrome trace is
written under ``--out``.  Runs on the card unless ``--device cpu``; trailing
config options (``MODEL.RESNETS.DEPTH 26 ...``) shrink the model, as the
CPU test does.
"""

import argparse
import itertools
import os
import runpy
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from microbench_torch import chip_smoke_here  # noqa: E402

SEED = 0


def build_cfg(args, inputs):
    from unit_tpu_torch.config import get_cfg

    recipe = {"train": inputs.FLAGSHIP, "tta": inputs.FLAGSHIP, "meta": inputs.META_RECIPE,
              "dock": inputs.DOCK_RECIPE}[args.path]
    cfg = get_cfg()
    cfg.merge_from_file(str(recipe))
    if args.depth is not None:
        cfg.MODEL.RESNETS.DEPTH = args.depth
    cfg.TPU.GRAD_ACCUM = args.grad_accum
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True  # random weights diverge without it
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.MODEL.ROI_HEADS.EMBEDDING_PATH = str(inputs.ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH)
    if args.opts:
        cfg.merge_from_list(args.opts)
    return cfg


def train_canvases(cfg):
    """The recipe's largest train canvas, landscape and portrait, each with a
    3:4 image resized into it (chip_smoke.TRAIN_CANVASES for the flagship)."""
    from unit_tpu_torch.data.transforms import TransformConfig

    canvas = TransformConfig.train_from_cfg(cfg).canvas
    short = max(cfg.INPUT.MIN_SIZE_TRAIN)
    content = (short, min(int(round(short * 4 / 3)), cfg.INPUT.MAX_SIZE_TRAIN))
    return ((canvas, content), (canvas[::-1], content[::-1]))


def step_fn(args, inputs, cfg, dev):
    """(model, the callable traced once a step): a train step, or a TTA
    predict of one image that ends in a device-to-host copy."""
    import torch

    from unit_tpu_torch.engine.predict import make_tta_predict_fn
    from unit_tpu_torch.engine.train import Trainer, TrainerNoMeta
    from unit_tpu_torch.solver import build_optimizer
    from unit_tpu_torch.utils.profiling import annotated

    model = inputs.flagship_model(cfg, SEED, dev)
    if args.path == "tta":
        cfg.TEST.AUG.ENABLED = True
        batch, _ = inputs.tta_batch(cfg, SEED)
        predict = make_tta_predict_fn(model, tta_topk=cfg.TPU.TTA_PROPOSAL_TOPK)

        def tta():
            dets = predict(batch)
            return torch.cat([dets.boxes.flatten(), dets.scores.flatten()]).cpu()

        return model, tta
    solver = build_optimizer(cfg, model)
    if solver.clip is not None:  # the clip is the optimizer's part of the step
        solver = solver._replace(clip=annotated(solver.clip, "optimizer"))
    n = 4 * args.grad_accum
    strong, weak = inputs.synthetic_train_batches(cfg, SEED, n_batches=n, per_stream=args.batch,
                                                  canvases=train_canvases(cfg))
    meta = None
    if args.path == "dock":
        writer = runpy.run_path(str(inputs.ROOT / "scripts" / "make_shapes_proposals_torch.py"))
        strong, weak = inputs.with_dock_proposals(
            writer["mcg_like_proposals"], np.random.RandomState(SEED + 170), strong, weak,
            cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN)
    if args.path == "meta":
        meta = itertools.cycle(inputs.synthetic_support_batches(cfg, SEED + 21))
    cls = Trainer if args.path == "meta" else TrainerNoMeta
    trainer = cls(model, solver, itertools.cycle(strong), itertools.cycle(weak), meta_iter=meta,
                  seed=SEED, grad_accum=args.grad_accum)
    trainer.init_state()
    return model, trainer.run_step  # ends in one device-to-host copy of the losses


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory of the Chrome trace")
    ap.add_argument("--path", choices=("train", "meta", "dock", "tta"), default="train")
    ap.add_argument("--steps", type=int, default=3, help="traced steps")
    ap.add_argument("--batch", type=int, default=2,
                    help="strong (and weak) images a micro-batch")
    ap.add_argument("--depth", type=int, default=None, help="ResNet depth (the recipe's)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--steady", type=int, default=0,
                    help="untraced steps after the warm-up, before the trace")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="config overrides")
    args = ap.parse_args()

    import torch
    from torch.profiler import record_function

    from unit_tpu_torch.engine.runner import resolve_device
    from unit_tpu_torch.utils.profiling import STEP_RANGE, annotate, newest_trace, trace

    dev = resolve_device(args.device)
    inputs = chip_smoke_here()
    if dev.type == "cuda":
        print(inputs.phase_env(), flush=True)
        inputs.phase_build()
    cfg = build_cfg(args, inputs)
    model, fn = step_fn(args, inputs, cfg, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    fn()
    sync()
    print(f"warm-up step {1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)
    for _ in range(args.steady):
        fn()
    sync()
    with annotate(model), trace(args.out):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            with record_function(STEP_RANGE):
                fn()
        sync()
        wall = time.perf_counter() - t0
    path = newest_trace(args.out)
    print(f"{args.steps} traced {args.path} steps, {1e3 * wall / args.steps:.1f} ms a step "
          f"under the profiler; trace written to {path} "
          f"({os.path.getsize(path) / 2**20:.1f} MiB)", flush=True)


if __name__ == "__main__":
    main()
