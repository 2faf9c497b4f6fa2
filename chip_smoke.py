#!/usr/bin/env python3
"""Build and drive unit_tpu_torch's serving, training and run-loop paths on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for the
sm_90a kernels) and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and the script exits non-zero):
  0  environment: card, power limit, torch/CUDA/nvcc versions, PyYAML, PIL
  1  build the four CUDA kernels from unit_tpu_torch/csrc, one nvcc each,
     all started together, timed
  2  K1 ROIAlignV2 forward vs its plain version at the flagship shapes
  3  K3 greedy-NMS mask vs its plain version (RPN, final and degenerate cases)
  4  serving end to end: the flagship VOC R-101-C4 detector at full width,
     random seeded weights, bf16, served by DetectionService.detect_array in
     both canvas orientations; launch counters prove the path ran K1, K3
     and K4 (one launch per FrozenBN); the same requests again with the plain
     epilogue, in turns
  5  whole serving path in f32 (TF32 off): predict_raw with the kernels
     (K1, K3, K4) vs with the plain versions
  6  K2 ROIAlignV2 backward vs its plain version at the flagship train-step
     shapes, f32 and bf16, with uniform ROIs, ROIs piled as a train step lays
     them out and ROIs in one band (row lists of several segments); two
     launches bit-identical; the wrapper's host time and scratch bytes
  7  training end to end: TrainerNoMeta takes 2 warm-up and 8 timed steps of
     the flagship recipe at full width (2 strong + 2 weak images per step,
     canvases alternating 800x1344 / 1344x800, bf16) with build_optimizer's
     SGD (gradients clipped: the weights are random); launch counters prove
     every step ran K1 x2, K2 x2, K3 x4 and K4 once per FrozenBN forward and
     once per differentiated FrozenBN backward; the same steps again with the
     plain epilogue, in turns
  8  whole train path in f32 (TF32 off): train_losses + backward with the
     kernels vs with the plain versions, same weights and generator seed
  9  K4 fused FrozenBN + residual + ReLU epilogue vs its plain version,
     forward and backward, bf16 and f32, at the flagship shapes and two narrow
     ones (bit-identical); times beside the four-op chain it replaces and the
     bound of the bytes it must move
 10  the run loop at full width and depth: engine.runner.run on a synthetic
     VOC devkit (XML and image sets on disk, images from a seeded loader):
     6 steps with checkpoints and evaluations every 3, a resume from step 3,
     --eval-only from step 6, one evaluation with TPU.FOLD_BN_AT_EVAL, and
     24 steps without hooks for the loader's steady rate
The last three lines are the card (nvidia-smi), one JSON object describing
the kernels (launches counted on the run loop of phase 10, and per path under
launches_by_path), and {"ok": true, "device": {...}}.  Without a CUDA device, or without the
unit_tpu_torch package beside it, the script fails before any result is
printed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "VOC" / "VOC-RCNN-101-C4-split1.yaml"

# Tolerances, each with its reason.
# K1 in f32: kernel and plain version compute the same f32 expression; they
# differ only by FMA contraction and summation order, a few f32 ulps of
# values of order 1 (unit-normal features).
K1_F32_ATOL = 2e-5
# K1 in bf16: both round their f32 result to bf16 once, so beyond the f32
# difference above they may differ by one bf16 ulp (2^-7 of the magnitude)
# where the two f32 values straddle a rounding boundary.
K1_BF16_ULPS = 1.0
# Whole path in f32: kernel vs plain ROIAlign differences (above) pass
# through Res5 and the heads; probabilities are bounded by 1, deltas are
# compared relative to their largest magnitude.
E2E_PROBS_ATOL = 1e-4
E2E_BBOX_RTOL = 1e-4
# Served requests, alternating landscape and portrait canvases.
REQUESTS = 6
# K2 in f32 vs its plain version, elementwise: |k - p| <= K2_REL * S, where
# S = roi_align_backward_plain(|g|) is the sum of the absolute values of the
# terms both add up (the bilinear weights are non-negative).  The two sum the
# same f32 products in different orders (K2 per feature row in ROI order, the
# plain version by index_add_), so they differ by a few f32 roundings of S;
# 2^-16 leaves a factor ~100 over 2^-23 while a missing or doubled sample
# moves a cell by one whole term.  bf16 output: one bf16 ulp beyond that.
K2_REL = 2.0 ** -16
# Train steps of phase 7, and their (canvas, content) sizes: a 600x800 image
# resized to the recipe's 800-pixel short side, in both orientations.
TRAIN_WARMUP = 2
TRAIN_STEPS = 8
TRAIN_CANVASES = (((800, 1344), (800, 1067)), ((1344, 800), (1067, 800)))
# Whole train path in f32, kernels vs plain versions: the proposals and the
# sampled slots are identical (K3 is exact); K1/K2 differ from their plain
# versions by f32 rounding (~5e-7), which the random-weight heads amplify:
# their logits are in the hundreds (loss_cls ~300), so a few leaves' gradients
# move by ~1e-3 of their own largest element (1.07e-3 on box_head res5
# block2 conv3 with --seed 0 on an H100, while the largest gradient of the
# network, G, is ~1e3 times larger).  Per leaf: max|diff| <= TRAIN_GRAD_REL * max|g_leaf|
# + TRAIN_GRAD_FLOOR * G.  A dropped or misweighted ROI sample moves the
# backbone's gradients (downstream of K2) and the losses by whole percents.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-3
TRAIN_GRAD_FLOOR = 1e-6
# The card's published peaks (NVIDIA H100 SXM data sheet), for each kernel's
# bound: the least time the card could take for the same work.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# K4 vs its plain version: bit-identical, in f32 and bf16, forward and
# backward.  The kernel does the plain version's f32 operations in its order
# with round-to-nearest intrinsics (nothing contracts into an FMA) and both
# round once to the activation's type.
K4_MAX_ABS_ERR = 0.0
# K4 shapes [N, H, W, C], (residual, relu): the stem, res2's and res4's conv3
# epilogue at one served image, a shortcut, res4 at a train step's 4 images,
# Res5 over 1024 ROIs, and two narrow ones (C = 4 and 130 take the scalar path).
K4_SHAPES = (
    ((1, 400, 672, 64), (False, True)),
    ((1, 50, 84, 256), (True, True)),
    ((1, 50, 84, 1024), (True, True)),
    ((1, 50, 84, 1024), (False, False)),
    ((4, 50, 84, 1024), (True, True)),
    ((1024, 7, 7, 2048), (True, True)),
    ((3, 5, 7, 4), (True, True)),
    ((2, 9, 11, 130), (True, True)),
)
K4_REPORTED = ((4, 50, 84, 1024), (True, True))  # the kernels line's K4 row
# Run loop (phase 10): steps, and how far the losses of a resumed run may be
# from the uninterrupted run's.  With cudnn.deterministic pinned every kernel
# of the step has a fixed summation order except PyTorch's own scatter/index
# kernels with float atomics (index_put_ with accumulate in the plain
# matcher/sampling and loss code); the script prints whether the two runs
# were bit-identical and holds them to this relative bound either way.
RUN_STEPS = 6
RUN_PERIOD = 3
RUN_TEST_IMAGES = 8
RUN_STEADY_STEPS = 24  # a longer run without hooks in the way: the loader's steady rate
RUN_EXTRA_OPTS = ()  # more config overrides (a rehearsal at a small size sets them)
RUN_DEVICE = "cuda"  # a rehearsal of the run loop's control flow sets "cpu"
RESUME_LOSS_RTOL = 1e-3
# Folded vs unfolded evaluation.  In f32 with TF32 off the fold moves one f32
# rounding per convolution: the res4 features agree to FOLD_F32_REL of their
# largest magnitude.  In bf16 it moves one bf16 rounding per convolution (the
# weight is scaled before its cast instead of the rounded output after it),
# and a random-weight R-101 amplifies every rounding over its 100
# convolutions, so the bound is the network's own bf16 noise: the folded bf16
# features may be at most FOLD_BF16_FACTOR times as far (mean |diff|) from
# the f32 features as the unfolded bf16 features are.
FOLD_F32_REL = 1e-3
FOLD_BF16_FACTOR = 2.0


def log(*parts):
    print(*parts, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters):
    """Median device time of fn() over iters runs, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_ms_queued(fn, iters):
    """(device ms, host ms) per call of fn() over ``iters`` back-to-back calls.

    For kernels shorter than a launch costs the host (tens of microseconds):
    the device is first held busy by a spin kernel, so the calls queue up
    behind it and the events bracket device work only; the host's own time
    per call is read from an un-queued run.  Median of 3 such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    reps = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(host * 2.5e9))  # cycles: longer than the host needs to enqueue
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / iters)
    return float(np.median(reps)), 1e3 * host / iters


def bound(bytes_moved, flops):
    """The least time the card could take for this work, in ms: its bytes
    (each input read once, each output written once) over the HBM rate, or
    its f32 operations over the f32 peak, whichever is larger, and which."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# f32 operations per output element of ROIAlignV2 (and per gradient element
# of its backward): 4 samples x 4 corners x (multiply, add).
ROI_ALIGN_FLOPS = 32
# f32 operations of one IoU test: 4 min/max, 2 subtract, 2 clamp, 1 multiply
# (intersection); 2 add, 1 subtract (union); 1 divide, 1 compare; the areas
# are amortised.
IOU_FLOPS = 14


# --------------------------------------------------------------------------- #
def phase_env():
    import torch

    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"[0] card: {card}")
    from unit_tpu_torch.ops import cuda_lib

    nvcc = run([cuda_lib.nvcc_path(), "--version"]).splitlines()[-1]
    try:
        import yaml  # noqa: F401  (unit_tpu_torch.config reads the recipes with it)
        has_yaml = f"yes ({yaml.__version__})"
    except ImportError:
        has_yaml = "no"
    try:
        import PIL  # noqa: F401  (data.transforms.load_image_bgr reads image files with it)
        has_pil = f"yes ({PIL.__version__})"
    except ImportError:
        has_pil = "no"
    log(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc {nvcc}, PyYAML {has_yaml}, PIL {has_pil}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    from unit_tpu_torch.ops import bn_act_cuda, cuda_lib, nms_cuda, roi_align_cuda

    t0 = time.perf_counter()
    loaders = (roi_align_cuda._lib, roi_align_cuda._bwd_lib, nms_cuda._lib, bn_act_cuda._lib)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()
    log(f"[1] built the four kernels in {time.perf_counter() - t0:.1f} s (in parallel)")
    for name, (secs, report) in cuda_lib.BUILD_LOG.items():
        log(f"[1] {name}: nvcc {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1]   {line.strip()}")


def flagship_rois(rng, n, h_img=800, w_img=1344):
    """n ROIs on the 800x1344 canvas plus edge cases in the first slots."""
    x1 = rng.uniform(-64, w_img, n)
    y1 = rng.uniform(-64, h_img, n)
    rois = np.stack([x1, y1, x1 + rng.uniform(1, 700, n), y1 + rng.uniform(1, 500, n)], -1)
    edge = np.asarray([
        [0, 0, w_img, h_img],                   # whole canvas
        [w_img - 40, h_img - 40, w_img, h_img],  # touching the last row and column
        [w_img - 8, h_img - 8, w_img, h_img],    # the last feature cell
        [-200, -200, 40, 30],                   # partly outside
        [w_img + 100, h_img + 50, w_img + 300, h_img + 90],  # fully outside
        [300, 200, 301, 200.5],                 # sub-bin
        [0, 0, 0, 0],                           # degenerate
    ], np.float64)
    rois[: len(edge)] = edge
    return rois.astype(np.float32)


def phase_k1(rng):
    import torch

    from unit_tpu_torch.ops import roi_align as ra

    dev = torch.device("cuda")
    worst_f32 = worst_bf16 = 0.0
    times = {}
    for b in (1, 2):
        feat = torch.as_tensor(rng.randn(b, 50, 84, 1024).astype(np.float32), device=dev)
        feat = feat.to(torch.bfloat16)
        rois = torch.as_tensor(np.stack([flagship_rois(rng, 1000) for _ in range(b)]), device=dev)
        # f32: the algorithm
        f32 = feat.float()
        got = ra.roi_align_batched(f32, rois, impl="cuda")
        want = ra.roi_align_batched(f32, rois, impl="plain")
        torch.cuda.synchronize()
        err32 = float((got - want).abs().max())
        # bf16: the working type, compared in ulps of the output
        got16 = ra.roi_align_batched(feat, rois, impl="cuda").float()
        want16 = ra.roi_align_batched(feat, rois, impl="plain").float()
        diff = (got16 - want16).abs()
        ulp = torch.maximum(got16.abs(), want16.abs()) * 2.0 ** -7
        ulps = float(((diff - K1_F32_ATOL).clamp_min(0.0) / ulp.clamp_min(1e-30)).max())
        err16 = float(diff.max())
        log(f"[2] K1 [{b},50,84,1024] x 1000 ROIs: f32 max|diff| {err32:.3g} "
            f"(tol {K1_F32_ATOL}), bf16 max|diff| {err16:.3g} = {ulps:.2f} ulp "
            f"beyond the f32 tol (tol {K1_BF16_ULPS} ulp)")
        if not np.isfinite(err32) or err32 > K1_F32_ATOL:
            raise AssertionError(f"K1 f32 disagrees with its plain version: {err32}")
        if not np.isfinite(ulps) or ulps > K1_BF16_ULPS:
            raise AssertionError(f"K1 bf16 disagrees with its plain version: {ulps} ulp")
        worst_f32, worst_bf16 = max(worst_f32, err32), max(worst_bf16, err16)
        k_ms = cuda_ms(lambda: ra.roi_align_batched(feat, rois, impl="cuda"), 20)
        p_ms = cuda_ms(lambda: ra.roi_align_batched(feat, rois, impl="plain"), 3)
        out_elems = b * 1000 * 14 * 14 * 1024
        times[b] = (k_ms, p_ms, bound(nbytes(feat, rois) + out_elems * feat.element_size(),
                                      out_elems * ROI_ALIGN_FLOPS))
        log(f"[2] K1 B={b} bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median, CUDA "
            f"events); bound {times[b][2]['bound_ms']:.4f} ms by {times[b][2]['bound_by']}")
    # tiny shapes: odd sizes, H = 1 and W = 1 maps
    for shape in ((1, 1, 5, 8), (2, 7, 1, 6), (1, 9, 11, 130)):
        feat = torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
        rois = torch.as_tensor(
            np.stack([flagship_rois(rng, 17, shape[1] * 16, shape[2] * 16)
                      for _ in range(shape[0])]), device=dev)
        err = float((ra.roi_align_batched(feat, rois, 7, impl="cuda")
                     - ra.roi_align_batched(feat, rois, 7, impl="plain")).abs().max())
        log(f"[2] K1 {shape} x 17 ROIs P=7 f32: max|diff| {err:.3g}")
        if not err <= K1_F32_ATOL:
            raise AssertionError(f"K1 disagrees at {shape}: {err}")
    return {"max_abs_err": worst_bf16, "ms": times[1][0], "plain_ms": times[1][1],
            **times[1][2], "library_ms": None}  # no one PyTorch call computes ROIAlignV2


def piled_rois(rng, n, h_img=800, w_img=1344):
    """ROIs as the train path lays them out: half jittered around three
    objects (sampled fg/bg slots), a quarter clipped flat against the bottom
    and right borders (invalid proposal slots), the rest uniform."""
    rois = flagship_rois(rng, n, h_img, w_img)
    objs = np.asarray([[100, 120, 400, 500], [600, 300, 900, 700], [1000, 50, 1300, 350]])
    k = n // 2
    rois[:k] = objs[rng.randint(3, size=k)] + rng.randn(k, 4) * 20
    flat = slice(k, k + n // 4)
    x1 = rng.uniform(0, w_img, n // 4)
    rois[flat] = np.stack([x1, np.full(n // 4, h_img), x1 + rng.uniform(1, 300, n // 4),
                           np.full(n // 4, h_img)], -1)
    rois[k:k + n // 8, 0] = w_img
    rois[k:k + n // 8, 2] = w_img
    return rois.astype(np.float32)


def one_band_rois(rng, n, h_img=800, w_img=1344):
    """ROIs that all lie in one 40-pixel band of the canvas: two or three
    feature rows carry every ROI, so their lists run to n entries."""
    rois = flagship_rois(rng, n, h_img, w_img)
    rois[:, 1] = h_img * 0.4 + rng.uniform(0, 10, n)
    rois[:, 3] = rois[:, 1] + rng.uniform(0, 30, n)
    return rois.astype(np.float32)


def clustered_boxes(rng, n, h=800, w=1344):
    """RPN-like boxes: clusters of overlapping boxes, some zero-area."""
    centers = rng.uniform(0, 1, (max(1, n // 20), 2)) * [w, h]
    c = centers[rng.randint(len(centers), size=n)] + rng.randn(n, 2) * 20
    wh = rng.uniform(8, 300, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    return boxes.astype(np.float32)


def phase_k3(rng):
    import torch

    from unit_tpu_torch.ops import nms as nms_ops

    dev = torch.device("cuda")
    worst = [0.0]  # max |kernel - plain| over every keep mask compared (0 or 1)

    def same_mask(sorted_boxes, thr, cap, label):
        got = nms_ops.nms_sorted_mask(sorted_boxes, thr, cap, impl="cuda")
        want = nms_ops.nms_sorted_mask(sorted_boxes, thr, cap, impl="plain")
        n_diff = int((got != want).sum())
        worst[0] = max(worst[0], float((got.float() - want.float()).abs().max()))
        log(f"[3] K3 {label}: {int(got.sum())} kept, {n_diff} rows differ")
        if n_diff:
            raise AssertionError(f"K3 keep mask differs from its plain version ({label})")

    # RPN: 6000 boxes, IoU 0.7, first 1000 keeps
    boxes = torch.as_tensor(clustered_boxes(rng, 6000), device=dev)
    scores = torch.as_tensor(rng.rand(6000).astype(np.float32), device=dev)
    sb = boxes[torch.argsort(-scores, stable=True)].contiguous()
    same_mask(sb, 0.7, 1000, "6000 boxes, IoU 0.7, max_keep 1000")
    same_mask(sb, 0.7, None, "6000 boxes, IoU 0.7, no cap")
    ki, kv = nms_ops.nms(boxes, scores, 0.7, 1000, impl="cuda")
    pi, pv = nms_ops.nms(boxes, scores, 0.7, 1000, impl="plain")
    if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
        raise AssertionError("K3: nms() indices differ from the plain version (RPN)")
    rpn_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.7, 1000, impl="cuda"), 20)
    rpn_plain = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.7, 1000, impl="plain"), 3)
    # The work this run's boxes need: exact greedy NMS tests each box, up to
    # the row of the last keep it returns, against the boxes kept before it.
    keep = nms_ops.nms_sorted_mask(sb, 0.7, 1000, impl="cuda")
    kept = int(keep.sum())
    last = int(keep.nonzero().max()) if kept else 0
    tests = int(torch.cumsum(keep[: last + 1].long(), 0).sum()) - kept
    rpn_bound = bound(nbytes(sb, keep), tests * IOU_FLOPS)
    log(f"[3] K3 RPN mask: kernel {rpn_ms:.4f} ms, plain {rpn_plain:.4f} ms; {kept} keeps, "
        f"the last at row {last}: {tests} IoU tests of a box against an earlier keep, "
        f"bound {rpn_bound['bound_ms']:.5f} ms by {rpn_bound['bound_by']} (a serial walk "
        f"of {kept} dependent keeps is not in this bound)")

    # final detections: 1000 proposals x 20 classes, class-offset, IoU 0.5, 100 out
    p, c = 1000, 20
    boxes = torch.as_tensor(clustered_boxes(rng, p * c), device=dev)
    probs = torch.as_tensor(rng.dirichlet(np.ones(c + 1) * 0.05, p)[:, :c].astype(np.float32),
                            device=dev).reshape(-1)
    classes = torch.arange(c, device=dev).repeat(p)
    valid = probs > 0.05
    ki, kv = nms_ops.batched_nms(boxes, probs, classes, 0.5, 100, valid=valid, impl="cuda")
    pi, pv = nms_ops.batched_nms(boxes, probs, classes, 0.5, 100, valid=valid, impl="plain")
    log(f"[3] K3 20000 class-offset boxes ({int(valid.sum())} above 0.05), IoU 0.5, "
        f"100 out: {int(kv.sum())} kept")
    if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
        raise AssertionError("K3: batched_nms() differs from the plain version (final)")
    shifted = boxes + (classes.float() * (boxes.max() + 1.0))[:, None]
    order = torch.argsort(-torch.where(valid, probs, -1e30), stable=True)
    sb = torch.where(valid[order][:, None], shifted[order], 0.0).contiguous()
    same_mask(sb, 0.5, 100, "20000 shifted boxes, IoU 0.5, max_keep 100")
    fin_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.5, 100, impl="cuda"), 20)
    fin_plain = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.5, 100, impl="plain"), 3)
    log(f"[3] K3 final mask: kernel {fin_ms:.4f} ms, plain {fin_plain:.4f} ms")

    # degenerate boxes (zero width/height) interleaved with duplicates
    boxes = clustered_boxes(rng, 700)
    boxes[::3, 2] = boxes[::3, 0]
    boxes[1::5, 3] = boxes[1::5, 1]
    boxes[2::7] = boxes[3::7][: len(boxes[2::7])]
    same_mask(torch.as_tensor(boxes, device=dev), 0.5, None, "700 boxes with zero-area rows")
    return {"max_abs_err": worst[0], "ms": rpn_ms, "plain_ms": rpn_plain, **rpn_bound,
            "library_ms": None}  # torchvision's nms is not installed and not used


def calibrate_frozen_bn(model, image, size):
    """Give the seeded weights the statistics of a trained network.

    With identity FrozenBN, lecun-normal convs grow the residual stream about
    40x in scale over R-101's 33 blocks, and the RPN's normal(0.01) head then
    decodes every anchor off the image: no proposal survives.  A trained
    checkpoint's FrozenBN normalises its input instead.  So every FrozenBN
    takes the per-channel mean and variance of its own input during one
    forward pass, in execution order (each layer sees calibrated upstream
    layers), on a synthetic image made from the seed.
    """
    import torch

    from unit_tpu_torch.models.resnet import FrozenBN

    def hook(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook)
               for m in model.modules() if isinstance(m, FrozenBN)]
    try:
        with torch.no_grad():
            model.predict_raw(image, size)
    finally:
        for h in handles:
            h.remove()


def flagship_model(cfg, seed, dev):
    """The recipe's detector at full width: seeded weights, GloVe embeddings,
    FrozenBN statistics calibrated on one seeded synthetic image."""
    import torch

    from unit_tpu_torch.checkpoint import load_glove_embeddings
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.models import WSRCNN, ModelConfig

    mc = ModelConfig.from_cfg(cfg)
    model = WSRCNN(mc, generator=torch.Generator().manual_seed(seed))
    load_glove_embeddings(model, str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH))
    model = model.to(dev).eval()
    rng = np.random.RandomState(seed + 100)
    s = prepare_test_image(rng.uniform(0, 255, (375, 500, 3)).astype(np.float32),
                           TransformConfig.test_from_cfg(cfg))
    calibrate_frozen_bn(model, torch.as_tensor(s["image"][None], device=dev),
                        torch.as_tensor(s["image_size"][None], device=dev))
    return model


def frozen_bn_counts(model):
    """FrozenBN modules (one K4 forward launch each per pass) of the backbone
    and of one Res5 head, and how many of the backbone's sit behind a
    trainable convolution (one K4 backward launch each per step)."""
    from unit_tpu_torch.models.resnet import FrozenBN

    def walk(root):
        total = trainable = 0
        for parent in root.modules():
            for name, child in parent.named_children():
                if isinstance(child, FrozenBN):
                    total += 1
                    trainable += bool(getattr(parent, name[: -len("_bn")]).weight.requires_grad)
        return total, trainable

    backbone, backbone_trainable = walk(model.backbone)
    res5, _ = walk(model.box_head)
    return backbone, res5, backbone_trainable


def reset_launch_counts():
    from unit_tpu_torch.ops import bn_act_cuda, nms_cuda, roi_align_cuda

    for fn in (roi_align_cuda.roi_align_cuda, roi_align_cuda.roi_align_backward_cuda,
               nms_cuda.nms_sorted_mask_cuda, bn_act_cuda.bn_act_forward_cuda,
               bn_act_cuda.bn_act_backward_cuda):
        fn.launches = 0
    bn_act_cuda.layout_copies = 0


def read_launch_counts():
    from unit_tpu_torch.ops import bn_act_cuda, nms_cuda, roi_align_cuda

    return {"roi_align_fwd": roi_align_cuda.roi_align_cuda.launches,
            "roi_align_bwd": roi_align_cuda.roi_align_backward_cuda.launches,
            "nms_mask": nms_cuda.nms_sorted_mask_cuda.launches,
            "bn_act_fwd": bn_act_cuda.bn_act_forward_cuda.launches,
            "bn_act_bwd": bn_act_cuda.bn_act_backward_cuda.launches,
            "bn_act_layout_copies": bn_act_cuda.layout_copies}


def phase_e2e(cfg, seed):
    import torch

    from unit_tpu_torch.data.transforms import prepare_test_image
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.models.similarity import VOC_CLASSES
    from unit_tpu_torch.serving import DetectionService

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = flagship_model(cfg, seed, dev)
    mc = model.mc
    log(f"[4] R-{mc.depth}-C4 built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, compute "
        f"{mc.compute_dtype}, multi_box_head {mc.multi_box_head}, RPN "
        f"{mc.rpn.pre_nms_topk_test}->{mc.rpn.post_nms_topk_test} @ {mc.rpn.nms_thresh}, "
        f"ROIAlign {mc.pooler_resolution}x{mc.pooler_resolution} s={mc.sampling_ratio}, "
        f"transfer {mc.sim.terms}")
    svc = DetectionService(cfg, model, class_names=VOC_CLASSES)
    t0 = time.perf_counter()
    svc.warmup()
    torch.cuda.synchronize()
    log(f"[4] warm-up, one request per orientation: {time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(seed + 1)
    shapes = [(375, 500), (500, 375)]
    images = [rng.uniform(0, 255, shapes[i % 2] + (3,)).astype(np.float32)
              for i in range(REQUESTS)]
    def serve_all():
        lat, results = [], []
        for img in images:
            t0 = time.perf_counter()
            results.append(svc.detect_array(img))  # ends in a device-to-host copy
            lat.append((time.perf_counter() - t0) * 1e3)
        return lat, results

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, results = serve_all()
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[4] {REQUESTS} requests, latency ms {[round(v, 2) for v in lat]}, "
        f"median {np.median(lat):.2f}, peak device memory {peak / 2**20:.1f} MiB")
    n_backbone, n_res5, _ = frozen_bn_counts(model)
    k4_per_request = n_backbone + (2 if mc.multi_box_head else 1) * n_res5
    log(f"[4] launches during the requests: {launches}; FrozenBN modules: backbone "
        f"{n_backbone}, one Res5 head {n_res5} -> {k4_per_request} K4 launches a request")
    want = {"roi_align_fwd": REQUESTS, "roi_align_bwd": 0, "nms_mask": 2 * REQUESTS,
            "bn_act_fwd": k4_per_request * REQUESTS, "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    if launches != want:
        raise AssertionError(f"the path did not run K1 x1, K3 x2 and K4 x{k4_per_request} "
                             f"per request without layout copies: {launches}")
    # the same requests with the plain epilogue and with K4, in turns
    medians = {"cuda": [float(np.median(lat))], "plain": []}
    for impl in ("plain", "cuda", "plain"):
        set_bn_act_impl(model, impl)
        svc.warmup()
        medians[impl].append(float(np.median(serve_all()[0])))
    set_bn_act_impl(model, "cuda")
    log(f"[4] request medians ms, bn_act_impl in turns: cuda {medians['cuda']}, plain "
        f"{medians['plain']}")
    for img, dets in zip(images, results):
        h, w = img.shape[:2]
        for d in dets:
            x1, y1, x2, y2 = d["box"]
            if not (np.isfinite(d["box"]).all() and np.isfinite(d["score"])):
                raise AssertionError(f"non-finite detection {d}")
            if not (0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h and 0 < d["score"] <= 1):
                raise AssertionError(f"detection outside the image or score range: {d}")
    log(f"[4] detections per request: {[len(r) for r in results]}")

    # proposals and raw outputs of one request per orientation (not counted)
    for shape in shapes:
        s = prepare_test_image(images[shapes.index(shape)], svc.tcfg)
        with torch.inference_mode():
            probs, bbox, props, feats = model.predict_raw(
                torch.as_tensor(s["image"][None], device=dev),
                torch.as_tensor(s["image_size"][None], device=dev))
        n_prop = int(props.valid.sum())
        finite = bool(torch.isfinite(probs).all() and torch.isfinite(bbox).all()
                      and torch.isfinite(feats.float()).all())
        log(f"[4] {shape} -> canvas {tuple(s['image'].shape[:2])}: features "
            f"{tuple(feats.shape)} {feats.dtype}, {n_prop} valid proposals of "
            f"{props.valid.shape[1]}, probs {tuple(probs.shape)}, finite {finite}")
        if n_prop <= 0 or not finite:
            raise AssertionError("no proposals or non-finite raw outputs")
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        prepare_test_image(images[0], svc.tcfg)
        host.append((time.perf_counter() - t0) * 1e3)
    log(f"[4] host-side resize to the canvas (numpy), median of 3: {np.median(host):.2f} ms")
    profile_request(svc, images[0])
    del svc, model
    torch.cuda.empty_cache()
    return launches


# Kernel names -> the layer they belong to, for the profiled breakdowns.
KERNEL_KINDS = (
    ("K1 roi_align_fwd", ("roi_align_fwd",)),
    ("K2 roi_align_bwd", ("roi_align_bwd",)),
    ("K3 nms_mask", ("iou_mask", "greedy_walk")),
    ("K4 bn_act", ("bn_act",)),
    ("cuDNN conv", ("xmma", "implicit_gemm", "cudnn", "conv2d")),
    ("cuBLAS matmul", ("nvjet", "gemm", "cutlass")),
    ("copies", ("Memcpy", "Memset", "copy")),
    ("sort/scan/index", ("sort", "Sort", "scan", "index", "gather", "scatter")),
    ("elementwise/reduce", ("elementwise", "reduce", "Reduce", "foreach")),
)


def profile_request(svc, image):
    """Where one request's time goes: torch.profiler over one more request."""
    profile_run(lambda: svc.detect_array(image), "[4]", "request")


def profile_run(fn, tag, what, top=15):
    """torch.profiler over one fn() that ends in a device-to-host copy:
    wall time, device busy share and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the CPU-side aten ops carry
    # the same device time again, and so do annotated ranges such as
    # Optimizer.step#SGD.step
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    log(f"{tag} profiled {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%), "
        f"{n_ops} device ops")
    by_kind = {}
    for ms, count, key in rows:
        kind = next((k for k, frags in KERNEL_KINDS if any(f in key for f in frags)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    log(f"{tag} device ms by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"{tag}   {ms:9.3f} ms  x{count:<5d} {key[:110]}")
    torch.cuda.synchronize()


def phase_whole_path(cfg, seed):
    import torch

    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.models.resnet import set_bn_act_impl

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[5] f32 model, cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    dev = torch.device("cuda")
    model = flagship_model(cfg32, seed, dev)
    rng = np.random.RandomState(seed + 2)
    s = prepare_test_image(rng.uniform(0, 255, (375, 500, 3)).astype(np.float32),
                           TransformConfig.test_from_cfg(cfg32))
    img = torch.as_tensor(s["image"][None], device=dev)
    size = torch.as_tensor(s["image_size"][None], device=dev)
    outs = {}
    for impl in ("cuda", "plain"):
        model.mc = dataclasses.replace(model.mc, roi_align_impl=impl, nms_impl=impl)
        set_bn_act_impl(model, impl)
        with torch.inference_mode():
            probs, bbox, props, _ = model.predict_raw(img, size)
        outs[impl] = (probs, bbox, props)
    (pk, bk, prk), (pp, bp, prp) = outs["cuda"], outs["plain"]
    same_props = torch.equal(prk.valid, prp.valid) and torch.equal(prk.boxes, prp.boxes)
    dprobs = float((pk - pp).abs().max())
    dbbox = float((bk - bp).abs().max()) / max(1.0, float(bp.abs().max()))
    log(f"[5] proposals identical: {same_props} ({int(prk.valid.sum())} valid); probs "
        f"max|diff| {dprobs:.3g} (tol {E2E_PROBS_ATOL}); bbox max|diff|/max|bbox| "
        f"{dbbox:.3g} (tol {E2E_BBOX_RTOL})")
    if not (same_props and dprobs <= E2E_PROBS_ATOL and dbbox <= E2E_BBOX_RTOL):
        raise AssertionError("the whole path with kernels disagrees with the plain path")

def phase_k2(rng):
    import torch

    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.ops.roi_align_cuda import BWD_TUNING, roi_align_backward_cuda

    dev = torch.device("cuda")

    def check(g, rois, shape, p, label):
        got = roi_align_backward_cuda(g, rois, shape, p)
        again = roi_align_backward_cuda(g, rois, shape, p)
        want = ra.roi_align_backward_plain(g, rois, shape, p)
        s_abs = ra.roi_align_backward_plain(g.float().abs(), rois, shape, p)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        bound = s_abs * K2_REL
        if g.dtype == torch.bfloat16:
            bound = bound + torch.maximum(got.float().abs(), want.float().abs()) * 2.0 ** -7
        rel = float((diff / s_abs.clamp_min(1e-30)).max())
        same = torch.equal(got, again)
        log(f"[6] K2 {label}: max|diff| {float(diff.max()):.3g}, max|diff|/S {rel:.3g} "
            f"(bound {K2_REL:.3g}{' + 1 bf16 ulp' if g.dtype == torch.bfloat16 else ''}), "
            f"two launches bit-identical {same}")
        if not (bool((diff <= bound).all()) and same):
            raise AssertionError(f"K2 disagrees with its plain version ({label})")
        return float(diff.max())

    def timed(g, rois, shape, label):
        """Kernel and plain ms; the wrapper's host time and its scratch."""
        k_ms = cuda_ms(lambda: roi_align_backward_cuda(g, rois, shape), 10)
        p_ms = cuda_ms(lambda: ra.roi_align_backward_plain(g, rois, shape), 3)
        q_ms, host_ms = cuda_ms_queued(lambda: roi_align_backward_cuda(g, rois, shape), 10)
        sizes = roi_align_backward_cuda.scratch_bytes
        log(f"[6] K2 {label}: kernel {k_ms:.4f} ms ({q_ms:.4f} queued), plain {p_ms:.4f} ms "
            f"(median, CUDA events); wrapper host {1e3 * host_ms:.1f} us a call; scratch "
            f"{sizes['scratch'] / 1e6:.1f} MB allocated + workspace "
            f"{sizes['workspace'] / 1e6:.2f} MB")
        return k_ms, p_ms

    worst, times = 0.0, {}
    for b in (1, 2):
        shape = (b, 50, 84, 1024)
        rois = torch.as_tensor(np.stack([flagship_rois(rng, 512) for _ in range(b)]), device=dev)
        g32 = torch.as_tensor(rng.randn(b, 512, 14, 14, 1024).astype(np.float32), device=dev)
        check(g32, rois, shape, 14, f"[{b},512,14,14,1024] f32")
        g16 = g32.to(torch.bfloat16)
        if b == 2:
            # the train path's layout (ROIs piled onto a few rows), and rows whose
            # lists are longer than two of the kernel's segments
            piled = torch.as_tensor(np.stack([piled_rois(rng, 512) for _ in range(b)]),
                                    device=dev)
            long_rows = torch.as_tensor(np.stack([one_band_rois(rng, 512) for _ in range(b)]),
                                        device=dev)
            longest = int(ra.roi_row_lists(long_rows, 50, 84)[1].max())
            seg = BWD_TUNING["seg"]
            log(f"[6] K2 one-band ROIs: the longest row list has {longest} entries "
                f"({-(-longest // seg)} segments of at most {seg})")
            if longest <= 2 * seg:
                raise AssertionError("the one-band ROIs do not fill more than two segments")
            check(g32, piled, shape, 14, "[2,512,14,14,1024] f32 piled")
            check(g32, long_rows, shape, 14, "[2,512,14,14,1024] f32 one band")
        del g32
        worst = max(worst, check(g16, rois, shape, 14, f"[{b},512,14,14,1024] bf16"))
        k_ms, p_ms = timed(g16, rois, shape, f"B={b} bf16")
        out_bytes = int(np.prod(shape)) * g16.element_size()
        times[b] = (k_ms, p_ms, bound(nbytes(g16, rois) + out_bytes,
                                      g16.numel() * ROI_ALIGN_FLOPS))
        log(f"[6] K2 B={b} bf16: bound {times[b][2]['bound_ms']:.4f} ms by "
            f"{times[b][2]['bound_by']}")
        if b == 2:
            worst = max(worst, check(g16, piled, shape, 14, "[2,512,14,14,1024] bf16 piled"))
            timed(g16, piled, shape, "B=2 bf16 piled ROIs")
            worst = max(worst, check(g16, long_rows, shape, 14,
                                     "[2,512,14,14,1024] bf16 one band"))
            timed(g16, long_rows, shape, "B=2 bf16 one-band ROIs")
    # tiny shapes: odd sizes, H = 1 and W = 1 maps
    for shape in ((1, 1, 5, 8), (2, 7, 1, 6), (1, 9, 11, 130)):
        rois = torch.as_tensor(
            np.stack([flagship_rois(rng, 17, shape[1] * 16, shape[2] * 16)
                      for _ in range(shape[0])]), device=dev)
        g = torch.as_tensor(rng.randn(shape[0], 17, 7, 7, shape[3]).astype(np.float32),
                            device=dev)
        check(g, rois, shape, 7, f"{shape} x 17 ROIs P=7 f32")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": times[2][0], "plain_ms": times[2][1],
            **times[2][2], "library_ms": None}  # no one PyTorch call computes its backward


def synthetic_train_batches(cfg, seed, n_batches=4, per_stream=2, max_gt=5):
    """Strong and weak numpy batches made from ``seed``, their canvases
    alternating between the two of TRAIN_CANVASES (strong and weak of one
    step share the canvas).

    Random BGR content fills the content size, zero padding the rest; strong
    images carry 1..max_gt base-class boxes (padded to TPU.MAX_GT_BOXES),
    weak images a multi-hot label over all classes."""
    rng = np.random.RandomState(seed + 7)
    base = np.asarray(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
    n_cls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    g_cap = cfg.TPU.MAX_GT_BOXES
    strong, weak = [], []
    for k in range(n_batches):
        canvas, content = TRAIN_CANVASES[k % 2]

        def images():
            im = np.zeros((per_stream,) + canvas + (3,), np.float32)
            im[:, :content[0], :content[1]] = rng.uniform(
                0, 255, (per_stream,) + content + (3,)).astype(np.float32)
            return im

        sizes = np.asarray([content] * per_stream, np.float32)
        boxes = np.zeros((per_stream, g_cap, 4), np.float32)
        classes = np.zeros((per_stream, g_cap), np.int32)
        valid = np.zeros((per_stream, g_cap), bool)
        for i in range(per_stream):
            n = rng.randint(1, max_gt + 1)
            wh = rng.uniform(0.06, 0.5, (n, 2)) * np.asarray(content[::-1])
            xy = rng.uniform(0, 1, (n, 2)) * (np.asarray(content[::-1]) - wh)
            boxes[i, :n] = np.concatenate([xy, xy + wh], 1)
            classes[i, :n] = rng.choice(base, n)
            valid[i, :n] = True
        labels = np.zeros((per_stream, n_cls), np.float32)
        for i in range(per_stream):
            labels[i, rng.choice(n_cls, rng.randint(1, 4), replace=False)] = 1.0
        strong.append(dict(image=images(), gt_boxes=boxes, gt_classes=classes,
                           gt_valid=valid, image_size=sizes))
        weak.append(dict(image=images(), labels=labels, image_size=sizes))
    return strong, weak


def phase_train(cfg, seed):
    import torch

    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # The recipe starts from ImageNet weights; from random weights its SGD
    # diverges within ~10 steps of the LR ramp (losses ~1e15, then NaN), so
    # the smoke clips the gradient by its global norm (SOLVER.CLIP_GRADIENTS,
    # off in the recipe).
    cfg = cfg.clone()
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    model = flagship_model(cfg, seed, dev)
    solver = build_optimizer(cfg, model)
    mc = model.mc
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    strong, weak = synthetic_train_batches(cfg, seed)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    log(f"[7] R-{mc.depth}-C4 train set-up in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in start.values()) / 1e6:.1f} M trainable params in "
        f"{len(start)} tensors, {len(frozen)} frozen (FREEZE_AT "
        f"{cfg.MODEL.BACKBONE.FREEZE_AT}), {len(solver.optimizer.param_groups)} SGD groups, "
        f"gradient clipped to global norm {cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE}, "
        f"compute {mc.compute_dtype}, RPN train {mc.rpn.pre_nms_topk_train}->"
        f"{mc.rpn.post_nms_topk_train}, {mc.roi_batch_size} ROIs per strong image, "
        f"{mc.weak_proposal_count} per weak image")

    # which trainable tensors got a non-zero gradient in some step (on the
    # device; read once at the end)
    params = dict(model.named_parameters())
    had_grad = {n: torch.zeros((), dtype=torch.bool, device=dev) for n in start}

    def step(label):
        lr = solver.optimizer.param_groups[0]["lr"]
        t = time.perf_counter()
        m = trainer.run_step()  # ends in one device-to-host copy of the losses
        ms = (time.perf_counter() - t) * 1e3
        for n, flag in had_grad.items():
            if params[n].grad is not None:
                flag |= params[n].grad.ne(0).any()
        log(f"[7] step {trainer.state.step} ({label}) {ms:.1f} ms, lr {lr:.6g}: "
            + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
        return ms

    for _ in range(TRAIN_WARMUP):
        step("warm-up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = [step("timed") for _ in range(TRAIN_STEPS)]
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    imgs = 2 * strong[0]["image"].shape[0]
    log(f"[7] {TRAIN_STEPS} timed steps: median {med:.2f} ms (min {min(times):.2f}, max "
        f"{max(times):.2f}), {1e3 * imgs / med:.2f} images/s ({imgs} per step), peak "
        f"device memory {peak / 2**20:.1f} MiB")
    log(f"[7] launches during the timed steps: {launches}")
    # K4: one forward launch per FrozenBN of the fused backbone pass and of
    # the three Res5 passes; one backward launch per FrozenBN that autograd
    # differentiates (behind a trainable convolution: res3, res4 and the two
    # Res5 passes with gradient)
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)
    k4_fwd, k4_bwd = n_backbone + 3 * n_res5, n_trainable + 2 * n_res5
    log(f"[7] FrozenBN modules: backbone {n_backbone} ({n_trainable} behind a trainable "
        f"convolution), one Res5 head {n_res5} -> {k4_fwd} K4 forward and {k4_bwd} K4 "
        f"backward launches a step")
    want = {"roi_align_fwd": 2 * TRAIN_STEPS, "roi_align_bwd": 2 * TRAIN_STEPS,
            "nms_mask": 4 * TRAIN_STEPS, "bn_act_fwd": k4_fwd * TRAIN_STEPS,
            "bn_act_bwd": k4_bwd * TRAIN_STEPS,
            # the spatial mean after each Res5 pass with gradient hands its last
            # epilogue an NCHW-contiguous gradient: one counted conversion each
            "bn_act_layout_copies": 2 * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"the train path did not run K1 x2, K2 x2, K3 x4, K4 x{k4_fwd} "
                             f"forward and x{k4_bwd} backward per step with 2 layout "
                             f"copies: {launches}")
    # the same steps with the plain epilogue and with K4, in turns
    medians = {"cuda": [med], "plain": []}
    for impl in ("plain", "cuda", "plain"):
        set_bn_act_impl(model, impl)
        step(f"warm-up, bn_act {impl}")
        medians[impl].append(float(np.median([step(f"bn_act {impl}")
                                              for _ in range(TRAIN_STEPS)])))
    set_bn_act_impl(model, "cuda")
    log(f"[7] step medians ms, bn_act_impl in turns: cuda {medians['cuda']}, plain "
        f"{medians['plain']}")
    for metrics in trainer.metrics_history:
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite loss: {metrics}")
    zero_grad = [n for n, flag in had_grad.items() if not bool(flag)]
    still = [n for n, p in start.items() if torch.equal(p, params[n])]
    unmoved = [n for n in still if n not in zero_grad]
    changed = [n for n, p in frozen.items() if not torch.equal(p, params[n])]
    log(f"[7] trainable tensors moved: {len(start) - len(still)}/{len(start)}; with an "
        f"all-zero gradient in every step: {zero_grad}; frozen tensors bit-unchanged: "
        f"{len(frozen) - len(changed)}/{len(frozen)}")
    if unmoved or changed:
        raise AssertionError(f"trainable tensors with a gradient that did not move {unmoved[:5]}, "
                             f"changed frozen {changed[:5]}")
    profile_run(trainer.run_step, "[7]", "train step", top=20)
    del trainer, model, solver
    torch.cuda.empty_cache()
    return launches


def phase_train_whole_path(cfg, seed):
    import torch

    from unit_tpu_torch.models import rpn as rpn_lib
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.ops import sampling as sampling_ops
    from unit_tpu_torch.solver import build_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    dev = torch.device("cuda")
    model = flagship_model(cfg32, seed, dev)
    build_optimizer(cfg32, model)  # freezes the stem and res2
    strong, weak = synthetic_train_batches(cfg32, seed + 1, n_batches=1)
    strong = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    weak = {k: torch.as_tensor(v, device=dev) for k, v in weak[0].items()}

    # record the proposals and sampled slots train_losses draws
    recorded = []
    real_select, real_sample = rpn_lib.select_proposals, sampling_ops.label_and_sample_proposals

    def select(*a, **kw):
        out = real_select(*a, **kw)
        recorded.append(("proposals", out.boxes, out.valid))
        return out

    def sample(*a, **kw):
        out = real_sample(*a, **kw)
        recorded.append(("sampled", out.boxes, out.gt_classes, out.valid))
        return out

    runs = {}
    rpn_lib.select_proposals, sampling_ops.label_and_sample_proposals = select, sample
    try:
        for impl in ("cuda", "plain"):
            model.mc = dataclasses.replace(model.mc, roi_align_impl=impl, nms_impl=impl)
            set_bn_act_impl(model, impl)
            model.zero_grad(set_to_none=True)
            recorded.clear()
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            losses = model.train_losses(gen, strong, weak)
            torch.stack(list(losses.values())).sum().backward()
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None}
            runs[impl] = ({k: float(v.detach()) for k, v in losses.items()}, list(recorded),
                          grads)
    finally:
        rpn_lib.select_proposals = real_select
        sampling_ops.label_and_sample_proposals = real_sample
    (lk, rk, gk), (lp, rp, gp) = runs["cuda"], runs["plain"]
    same = len(rk) == len(rp) and all(
        a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
        for a, b in zip(rk, rp))
    loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    scale = {n: float(g.abs().max()) for n, g in gp.items()}
    big = max(scale.values())
    diffs = {n: float((gk[n] - gp[n]).abs().max()) for n in gp if n in gk}
    over = {n: d / (TRAIN_GRAD_REL * scale[n] + TRAIN_GRAD_FLOOR * big)
            for n, d in diffs.items()}
    log(f"[8] f32, TF32 off: proposals and sampled slots identical {same} ({len(rk)} "
        f"records); losses max rel diff {loss_rel:.3g} (tol {TRAIN_LOSS_RTOL}); "
        f"{len(gp)} gradients, largest |grad| G = {big:.4g}, worst max|diff|/bound "
        f"{max(over.values()):.3g} (bound {TRAIN_GRAD_REL} * max|g_leaf| + "
        f"{TRAIN_GRAD_FLOOR} * G)")
    for n in sorted(over, key=over.get, reverse=True)[:5]:
        log(f"[8]   {n}: max|diff| {diffs[n]:.3g}, max|g| {scale[n]:.3g}, "
            f"diff/bound {over[n]:.3g}")
    log(f"[8] losses (kernels): " + ", ".join(f"{k} {v:.6g}" for k, v in lk.items()))
    if not (same and set(gk) == set(gp) and loss_rel <= TRAIN_LOSS_RTOL
            and max(over.values()) <= 1.0):
        raise AssertionError("the train path with kernels disagrees with the plain path")
    del model
    torch.cuda.empty_cache()


def phase_k4(rng):
    import torch

    from unit_tpu_torch.ops import bn_act as ba
    from unit_tpu_torch.ops import bn_act_cuda as k4

    dev = torch.device("cuda")
    worst, reported = 0.0, None

    def chain(x, s16, t16, res, relu):
        """The four-op chain the model ran before the fused epilogue: scale
        and shift rounded to the activation's type, one pass per operation."""
        y = x * s16 + t16
        if res is not None:
            y = y + res
        return torch.relu(y) if relu else y

    for shape, (has_res, relu) in K4_SHAPES:
        n, h, w, c = shape
        scale = torch.as_tensor(rng.uniform(0.5, 1.5, c).astype(np.float32), device=dev)
        shift = torch.as_tensor((rng.randn(c) * 0.3).astype(np.float32), device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2 ** 31)))
        label = f"[{n},{h},{w},{c}] res={int(has_res)} relu={int(relu)}"
        for dtype in (torch.float32, torch.bfloat16):
            def nhwc():
                return torch.randn(shape, generator=gen, device=dev).to(dtype).permute(0, 3, 1, 2)

            x, res, g = nhwc(), (nhwc() if has_res else None), nhwc()
            outs = {}
            for impl in ("cuda", "plain"):
                xi = x.clone().requires_grad_(True)
                ri = res.clone().requires_grad_(True) if has_res else None
                y = ba.bn_act(xi, scale, shift, ri, relu, impl)
                y.backward(g)
                outs[impl] = [y.detach(), xi.grad] + ([ri.grad] if has_res else [])
                del xi, ri, y
            again = k4.bn_act_backward_cuda(g, outs["cuda"][0] if relu else None, scale, relu,
                                            need_dx=True, need_dres=has_res)
            torch.cuda.synchronize()
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(outs["cuda"], outs["plain"]))
            same = all(torch.equal(a, b) for a, b in zip(outs["cuda"], outs["plain"]))
            twice = all(torch.equal(a, b) for a, b in zip(outs["cuda"][1:], again))
            dense = all(k4.nhwc_dense(t) for t in outs["cuda"])
            log(f"[9] K4 {label} {str(dtype).split('.')[-1]}: forward and backward "
                f"max|diff| {err:.3g} (tol {K4_MAX_ABS_ERR}), bit-identical {same}, two "
                f"backward launches bit-identical {twice}, outputs NHWC-dense {dense}")
            if not (err <= K4_MAX_ABS_ERR and same and twice and dense):
                raise AssertionError(f"K4 disagrees with its plain version ({label} {dtype})")
            worst = max(worst, err)
            y_saved = outs["cuda"][0]
            del outs, again
        # times in bf16 (x, res, g, y_saved are the bf16 tensors of the last pass)
        s16 = scale.to(torch.bfloat16).view(1, -1, 1, 1)
        t16 = shift.to(torch.bfloat16).view(1, -1, 1, 1)
        with torch.no_grad():
            k_ms, k_host = cuda_ms_queued(
                lambda: k4.bn_act_forward_cuda(x, scale, shift, res, relu), 20)
            p_ms, _ = cuda_ms_queued(lambda: ba.bn_act_plain(x, scale, shift, res, relu), 10)
            c_ms, c_host = cuda_ms_queued(lambda: chain(x, s16, t16, res, relu), 10)
            kb_ms, _ = cuda_ms_queued(lambda: k4.bn_act_backward_cuda(
                g, y_saved if relu else None, scale, relu, True, has_res), 20)
            pb_ms, _ = cuda_ms_queued(
                lambda: ba.bn_act_backward_plain(g, y_saved, scale, relu), 10)
        elems = x.numel()
        # forward: x [+ res] read, out written; backward: g [+ y] read, dx [+ dres] written;
        # 3 or 4 f32 operations an element
        fwd = bound((2 + has_res) * elems * 2 + 8 * c, (3 + has_res) * elems)
        bwd = bound((2 + relu + (has_res and relu)) * elems * 2 + 4 * c, 2 * elems)
        log(f"[9] K4 {label} bf16 forward: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"four-op chain {c_ms:.4f} ms, bound {fwd['bound_ms']:.4f} ms by {fwd['bound_by']} "
            f"({100 * fwd['bound_ms'] / k_ms:.0f}% of the kernel's time); backward: kernel "
            f"{kb_ms:.4f} ms, plain {pb_ms:.4f} ms, bound {bwd['bound_ms']:.4f} ms; host time "
            f"to enqueue one call: kernel wrapper {k_host:.4f} ms, chain {c_host:.4f} ms")
        if (shape, (has_res, relu)) == K4_REPORTED:
            reported = {"ms": k_ms, "plain_ms": p_ms, **fwd, "library_ms": None,
                        "chain_ms": c_ms, "host_ms": k_host, "bwd_ms": kb_ms,
                        "bwd_plain_ms": pb_ms,
                        "bwd_bound_ms": bwd["bound_ms"]}
        del x, res, g, y_saved
        torch.cuda.empty_cache()
    # no one PyTorch call computes the epilogue (library_ms null); the chain is four calls
    return {"max_abs_err": worst, **reported}


_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>"""
_OBJ = """<object><name>{name}</name><difficult>0</difficult>
  <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
</object>"""


def write_devkit(root, seed, n_images=RUN_TEST_IMAGES):
    """A synthetic VOCdevkit under ``root``: annotations and image sets of
    VOC2007 trainval/test and VOC2012 trainval, 600x800 and 800x600 images in
    turn with 1-3 boxes each, no image files."""
    from unit_tpu_torch.models.similarity import VOC_CLASSES

    rng = np.random.RandomState(seed + 11)
    for year, splits in (("2007", ("trainval", "test")), ("2012", ("trainval",))):
        base = Path(root) / f"VOC{year}"
        for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
            (base / sub).mkdir(parents=True)
        for split in splits:
            ids = []
            for i in range(n_images):
                h, w = ((600, 800), (800, 600))[i % 2]
                image_id = f"{year}_{split}_{i:03d}"
                ids.append(image_id)
                objs = []
                for _ in range(rng.randint(1, 4)):
                    bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
                    x1, y1 = rng.randint(1, w - bw), rng.randint(1, h - bh)
                    objs.append(_OBJ.format(name=VOC_CLASSES[rng.randint(len(VOC_CLASSES))],
                                            x1=x1, y1=y1, x2=x1 + bw, y2=y1 + bh))
                (base / "Annotations" / f"{image_id}.xml").write_text(
                    _XML.format(w=w, h=h, objects="\n".join(objs)))
            (base / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(ids))
    return str(root)


def seeded_image_loader(rec):
    """Float BGR content made from the record's id."""
    rng = np.random.RandomState(zlib.crc32(rec["image_id"].encode()) % 2 ** 31)
    return rng.uniform(0, 255, (rec["height"], rec["width"], 3)).astype(np.float32)


def phase_run_loop(cfg, seed):
    import torch

    from unit_tpu_torch.checkpoint import Checkpointer, read_checkpoint
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import TrainerNoMeta, TrainState
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.solver import build_optimizer
    from unit_tpu_torch.utils.bn_fold import fold_frozen_bn

    dev = torch.device(RUN_DEVICE)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    made = []

    class Recording(TrainerNoMeta):
        """TrainerNoMeta that keeps itself, so the script can read its losses."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.step_ms = []
            made.append(self)

        def run_step(self):
            t = time.perf_counter()
            metrics = super().run_step()  # ends in the loss fetch
            self.step_ms.append((time.perf_counter() - t) * 1e3)
            return metrics

    def strip_time(results):
        return {k: v for k, v in results.items() if k != "inference_seconds_per_image"}

    with tempfile.TemporaryDirectory(prefix="unit_tpu_torch_run_") as tmp:
        devkit = write_devkit(os.path.join(tmp, "VOCdevkit"), seed)
        out_a, out_b = os.path.join(tmp, "run_a"), os.path.join(tmp, "run_b")
        # The recipe starts from ImageNet weights, which are not in the
        # repository: the run warm-starts from one of the port's own
        # checkpoints instead (MODEL.WEIGHTS), holding the seeded weights with
        # calibrated FrozenBN statistics, and clips its gradients as phase 7.
        t0 = time.perf_counter()
        model = flagship_model(cfg, seed, dev)
        init = Checkpointer(os.path.join(tmp, "init")).save(
            0, TrainState(model, build_optimizer(cfg, model), 0))
        del model
        torch.cuda.empty_cache()
        log(f"[10] devkit of {RUN_TEST_IMAGES} images a split and the initial checkpoint "
            f"({os.path.getsize(init) / 2**20:.1f} MiB) written in "
            f"{time.perf_counter() - t0:.1f} s")

        def run(out, *flags, opts=()):
            DatasetCatalog.clear()
            made.clear()
            args = runner.default_argument_parser().parse_args([
                "--config-file", str(FLAGSHIP), "--data-root", devkit, "--device", RUN_DEVICE,
                *flags,
                "MODEL.WEIGHTS", init, "OUTPUT_DIR", out,
                "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
                "DATASETS.CLASSIFIER_DATAROOT", devkit, "SEED", str(seed),
                "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(RUN_STEPS),
                "SOLVER.CHECKPOINT_PERIOD", str(RUN_PERIOD), "TEST.EVAL_PERIOD", str(RUN_PERIOD),
                "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm", *RUN_EXTRA_OPTS, *opts])
            t = time.perf_counter()
            results = runner.run(args, image_loader=seeded_image_loader)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            trainer = made[-1]
            first = trainer.state.step - len(trainer.metrics_history)
            losses = {first + 1 + k: m for k, m in enumerate(trainer.metrics_history)}
            return results, losses, trainer, time.perf_counter() - t

        real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
        try:
            # (a) 6 steps, checkpoints and evaluations at 3 and 6, a final evaluation
            reset_launch_counts()
            results_a, losses_a, trainer, secs = run(out_a)
            launches = read_launch_counts()
            log(f"[10] run of {RUN_STEPS} steps with 2 in-run evaluations and the final one "
                f"over {RUN_TEST_IMAGES} images: {secs:.1f} s; launches {launches}")
            for step, m in losses_a.items():
                log(f"[10]   step {step}: " + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
            files = sorted(os.listdir(out_a))
            bbox = results_a["bbox"]
            log(f"[10] output directory: {files}; AP {bbox['AP']:.4g}, AP50 {bbox['AP50']:.4g}, "
                f"AP75 {bbox['AP75']:.4g}, novel_mean {bbox['novel_mean']:.4g}; "
                f"{results_a['inference_seconds_per_image']:.4f} s per evaluated image (host "
                f"clock, after one warm-up image); data time per step, median "
                f"{1e3 * np.median([m['data_time'] for m in losses_a.values()]):.2f} ms")
            need = {"step_3.pt", "step_6.pt", "best", "best_info.json", "log.txt"}
            ok = (need <= set(files) and sorted(losses_a) == list(range(1, RUN_STEPS + 1))
                  and all(np.isfinite(v) for m in losses_a.values() for v in m.values())
                  and all(np.isfinite(bbox[k]) for k in ("AP", "AP50", "AP75", "novel_mean"))
                  and np.isfinite(results_a["inference_seconds_per_image"])
                  and all(launches[k] > 0 for k in ("roi_align_fwd", "roi_align_bwd",
                                                    "nms_mask", "bn_act_fwd", "bn_act_bwd")))
            if not ok:
                raise AssertionError("the run loop left out a checkpoint, a step, a finite "
                                     "result or a kernel")
            t = time.perf_counter()
            path = Checkpointer(os.path.join(tmp, "timed")).save(RUN_STEPS, trainer.state)
            log(f"[10] checkpoint (model, momentum, schedule, step): "
                f"{os.path.getsize(path) / 2**20:.1f} MiB, written and renamed in "
                f"{time.perf_counter() - t:.2f} s")
            del trainer

            # (b) resume from a copy that holds only step 3
            os.makedirs(out_b)
            shutil.copy(os.path.join(out_a, "step_3.pt"), out_b)
            results_b, losses_b, trainer, secs = run(out_b, "--resume")
            del trainer
            rel = max(abs(losses_b[s][k] - losses_a[s][k]) / max(abs(losses_a[s][k]), 1e-12)
                      for s in losses_b for k in losses_b[s] if k != "data_time")
            same = all(losses_b[s][k] == losses_a[s][k] for s in losses_b
                       for k in losses_b[s] if k != "data_time")
            ma = read_checkpoint(os.path.join(out_a, "step_6.pt"))["model"]
            mb = read_checkpoint(os.path.join(out_b, "step_6.pt"))["model"]
            same_params = all(torch.equal(ma[k], mb[k]) for k in ma)
            log(f"[10] resumed from step 3 in {secs:.1f} s: steps {sorted(losses_b)}, losses "
                f"bit-identical to the uninterrupted run's {same} (max rel diff {rel:.3g}, "
                f"tol {RESUME_LOSS_RTOL}), final parameters bit-identical {same_params}, "
                f"final AP equal {strip_time(results_b) == strip_time(results_a)}")
            if sorted(losses_b) != list(range(RUN_PERIOD + 1, RUN_STEPS + 1)) \
                    or not rel <= RESUME_LOSS_RTOL:
                raise AssertionError("the resumed run does not reproduce steps 4-6")

            # (c) --eval-only from the step-6 checkpoint equals the in-run evaluation
            results_c, losses_c, trainer, secs = run(out_a, "--eval-only", "--resume")
            del trainer
            log(f"[10] --eval-only from step 6 in {secs:.1f} s: results equal to the in-run "
                f"evaluation bit for bit {strip_time(results_c) == strip_time(results_a)}")
            if losses_c or strip_time(results_c) != strip_time(results_a):
                raise AssertionError("--eval-only does not reproduce the in-run evaluation")

            # (d) one evaluation with FrozenBN folded into the convolutions
            results_d, _, trainer, secs = run(out_a, "--eval-only", "--resume",
                                              opts=["TPU.FOLD_BN_AT_EVAL", "True"])
            net = trainer.model
            del trainer
            s = prepare_test_image(seeded_image_loader(
                {"image_id": "fold", "height": 600, "width": 800}),
                TransformConfig.test_from_cfg(cfg))
            img = torch.as_tensor(s["image"][None], device=dev)
            size = torch.as_tensor(s["image_size"][None], device=dev)
            cfg32 = cfg.clone()
            cfg32.TPU.COMPUTE_DTYPE = "float32"
            net32 = WSRCNN(ModelConfig.from_cfg(cfg32)).to(dev).eval()
            net32.load_state_dict(net.state_dict())
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            with torch.inference_mode():
                feats = {name: m.predict_raw(img, size)[3].float()
                         for name, m in (("bf16", net), ("bf16 folded", fold_frozen_bn(net)),
                                         ("f32", net32), ("f32 folded", fold_frozen_bn(net32)))}
            ref = feats["f32"]
            rel32 = float((feats["f32 folded"] - ref).abs().max() / ref.abs().max())
            far = {k: float((feats[k] - ref).abs().mean() / ref.abs().mean())
                   for k in ("bf16", "bf16 folded")}
            log(f"[10] TPU.FOLD_BN_AT_EVAL evaluation in {secs:.1f} s: AP50 "
                f"{results_d['bbox']['AP50']:.4g} (unfolded {bbox['AP50']:.4g}), "
                f"{results_d['inference_seconds_per_image']:.4f} s per image; res4 features of "
                f"one image, folded vs unfolded in f32: max|diff|/max {rel32:.3g} (tol "
                f"{FOLD_F32_REL}); mean|diff|/mean|f32| from the f32 features: bf16 "
                f"{far['bf16']:.3g}, bf16 folded {far['bf16 folded']:.3g} (tol "
                f"{FOLD_BF16_FACTOR} x the unfolded)")
            if not (np.isfinite(results_d["bbox"]["AP50"]) and rel32 <= FOLD_F32_REL
                    and far["bf16 folded"] <= FOLD_BF16_FACTOR * far["bf16"]):
                raise AssertionError("the folded evaluation is not finite or not close")
            del net, net32, feats
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True

            # (e) the loader's steady rate: more steps, no checkpoint or evaluation
            # between them, so the prefetch queues drain to what the host can make
            _, losses_e, trainer, secs = run(
                os.path.join(tmp, "run_e"),
                opts=["SOLVER.MAX_ITER", str(RUN_STEADY_STEPS), "SOLVER.CHECKPOINT_PERIOD", "0",
                      "TEST.EVAL_PERIOD", "0"])
            half = RUN_STEADY_STEPS // 2
            waits = [1e3 * losses_e[s]["data_time"] for s in sorted(losses_e)[half:]]
            steps = trainer.step_ms[half:]
            del trainer
            log(f"[10] {RUN_STEADY_STEPS} steps without hooks in {secs:.1f} s; over the last "
                f"{len(steps)}: step median {np.median(steps):.2f} ms "
                f"({4e3 / np.median(steps):.2f} images/s), of which waiting for the two "
                f"prefetched streams {np.median(waits):.2f} ms (median; min {min(waits):.2f}, "
                f"max {max(waits):.2f})")
            if len(losses_e) != RUN_STEADY_STEPS:
                raise AssertionError("the steady run did not take its steps")
        finally:
            runner.TrainerNoMeta = real_trainer
            made.clear()
            torch.cuda.empty_cache()
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from unit_tpu_torch.config import get_cfg

    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    rng = np.random.RandomState(args.seed)
    k1 = phase_k1(rng)
    k3 = phase_k3(rng)
    cfg = get_cfg()
    cfg.merge_from_file(str(FLAGSHIP))
    by_path = {"serving": phase_e2e(cfg, args.seed)}
    phase_whole_path(cfg, args.seed)
    k2 = phase_k2(rng)
    by_path["train"] = phase_train(cfg, args.seed)
    phase_train_whole_path(cfg, args.seed)
    k4 = phase_k4(rng)
    by_path["run_loop"] = launches = phase_run_loop(cfg, args.seed)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    def per_path(*names):
        return {path: sum(counts[n] for n in names) for path, counts in by_path.items()}

    # every kernel of a path was launched on it (K2 and K4's backward are not
    # on the serving path)
    for path, counts in by_path.items():
        for name, count in counts.items():
            on_path = not (path == "serving" and name.endswith("_bwd")) \
                and name != "bn_act_layout_copies"
            if on_path and count <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")

    kernels = [
        dict(name="roi_align_fwd", route="cuda", source="unit_tpu_torch/csrc/roi_align_fwd.cu",
             replaces="unit_tpu/ops/roi_align_pallas.py:230",
             launches=launches["roi_align_fwd"],
             launches_by_path=per_path("roi_align_fwd"), **k1),
        dict(name="roi_align_bwd", route="cuda", source="unit_tpu_torch/csrc/roi_align_bwd.cu",
             replaces="unit_tpu/ops/roi_align_pallas_bwd.py:564",
             launches=launches["roi_align_bwd"],
             launches_by_path=per_path("roi_align_bwd"), **k2),
        dict(name="nms_mask", route="cuda", source="unit_tpu_torch/csrc/nms_mask.cu",
             replaces="unit_tpu/ops/nms_pallas.py:115",
             launches=launches["nms_mask"], launches_by_path=per_path("nms_mask"), **k3),
        dict(name="bn_act", route="cuda", source="unit_tpu_torch/csrc/bn_act.cu",
             replaces="scripts/bench_backbone_epilogue.py:155",
             launches=launches["bn_act_fwd"] + launches["bn_act_bwd"],
             launches_by_path=per_path("bn_act_fwd", "bn_act_bwd"), **k4),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
