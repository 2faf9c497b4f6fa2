#!/usr/bin/env python3
"""Build and drive unit_tpu_torch's serving and training paths on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for the
sm_90a kernels) and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and the script exits non-zero):
  0  environment: card, power limit, torch/CUDA/nvcc versions, PyYAML
  1  build the three CUDA kernels from unit_tpu_torch/csrc, one nvcc each,
     all started together, timed
  2  K1 ROIAlignV2 forward vs its plain version at the flagship shapes
  3  K3 greedy-NMS mask vs its plain version (RPN, final and degenerate cases)
  4  serving end to end: the flagship VOC R-101-C4 detector at full width,
     random seeded weights, bf16, served by DetectionService.detect_array in
     both canvas orientations; launch counters prove the path ran K1 and K3
  5  whole serving path in f32 (TF32 off): predict_raw with the kernels vs
     with the plain versions
  6  K2 ROIAlignV2 backward vs its plain version at the flagship train-step
     shapes; two launches bit-identical
  7  training end to end: TrainerNoMeta takes 2 warm-up and 8 timed steps of
     the flagship recipe at full width (2 strong + 2 weak images per step,
     canvases alternating 800x1344 / 1344x800, bf16) with build_optimizer's
     SGD (gradients clipped: the weights are random); launch counters prove
     every step ran K1 x2, K2 x2 and K3 x4
  8  whole train path in f32 (TF32 off): train_losses + backward with the
     kernels vs with the plain versions, same weights and generator seed
The last three lines are the card (nvidia-smi), one JSON object describing
the kernels (launches counted on the train path of phase 7), and
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
unit_tpu_torch package beside it, the script fails before any result is
printed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import itertools
import json
import subprocess
import sys
import time
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


# --------------------------------------------------------------------------- #
def phase_env():
    import torch

    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"[0] card: {card}")
    from unit_tpu_torch.ops import cuda_lib

    nvcc = run([cuda_lib.nvcc_path(), "--version"]).splitlines()[-1]
    try:
        import yaml  # noqa: F401  (unit_tpu.config reads the recipes with it)
        has_yaml = f"yes ({yaml.__version__})"
    except ImportError:
        has_yaml = "no"
    log(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc {nvcc}, PyYAML {has_yaml}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    from unit_tpu_torch.ops import cuda_lib, nms_cuda, roi_align_cuda

    t0 = time.perf_counter()
    loaders = (roi_align_cuda._lib, roi_align_cuda._bwd_lib, nms_cuda._lib)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()
    log(f"[1] built the three kernels in {time.perf_counter() - t0:.1f} s (in parallel)")
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
        times[b] = (k_ms, p_ms)
        log(f"[2] K1 B={b} bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median, CUDA events)")
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
    return {"max_abs_err": worst_bf16, "ms": times[1][0], "plain_ms": times[1][1]}


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
    log(f"[3] K3 RPN mask: kernel {rpn_ms:.4f} ms, plain {rpn_plain:.4f} ms")

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
    return {"max_abs_err": worst[0], "ms": rpn_ms, "plain_ms": rpn_plain}


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


def phase_e2e(cfg, seed):
    import torch

    from unit_tpu_torch.data.transforms import prepare_test_image
    from unit_tpu_torch.models.similarity import VOC_CLASSES
    from unit_tpu_torch.ops.nms_cuda import nms_sorted_mask_cuda
    from unit_tpu_torch.ops.roi_align_cuda import roi_align_cuda
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
    torch.cuda.reset_peak_memory_stats()
    roi_align_cuda.launches = 0
    nms_sorted_mask_cuda.launches = 0
    lat, results = [], []
    for img in images:
        t0 = time.perf_counter()
        results.append(svc.detect_array(img))  # ends in a device-to-host copy
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = {"roi_align_fwd": roi_align_cuda.launches,
                "nms_mask": nms_sorted_mask_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"[4] {REQUESTS} requests, latency ms {[round(v, 2) for v in lat]}, "
        f"median {np.median(lat):.2f}, peak device memory {peak / 2**20:.1f} MiB")
    log(f"[4] launches during the requests: {launches}")
    if launches["roi_align_fwd"] != REQUESTS or launches["nms_mask"] != 2 * REQUESTS:
        raise AssertionError(f"the path did not run each kernel per request: {launches}")
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
    from unit_tpu_torch.ops.roi_align_cuda import roi_align_backward_cuda

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

    worst, times = 0.0, {}
    for b in (1, 2):
        shape = (b, 50, 84, 1024)
        rois = torch.as_tensor(np.stack([flagship_rois(rng, 512) for _ in range(b)]), device=dev)
        g32 = torch.as_tensor(rng.randn(b, 512, 14, 14, 1024).astype(np.float32), device=dev)
        check(g32, rois, shape, 14, f"[{b},512,14,14,1024] f32")
        g16 = g32.to(torch.bfloat16)
        del g32
        worst = max(worst, check(g16, rois, shape, 14, f"[{b},512,14,14,1024] bf16"))
        k_ms = cuda_ms(lambda: roi_align_backward_cuda(g16, rois, shape), 10)
        p_ms = cuda_ms(lambda: ra.roi_align_backward_plain(g16, rois, shape), 3)
        times[b] = (k_ms, p_ms)
        log(f"[6] K2 B={b} bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median, CUDA events)")
        if b == 2:  # the train path's layout: ROIs piled onto a few rows
            piled = torch.as_tensor(np.stack([piled_rois(rng, 512) for _ in range(b)]),
                                    device=dev)
            worst = max(worst, check(g16, piled, shape, 14, "[2,512,14,14,1024] bf16 piled"))
            k_ms = cuda_ms(lambda: roi_align_backward_cuda(g16, piled, shape), 10)
            p_ms = cuda_ms(lambda: ra.roi_align_backward_plain(g16, piled, shape), 3)
            log(f"[6] K2 B=2 bf16 piled ROIs: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    # tiny shapes: odd sizes, H = 1 and W = 1 maps
    for shape in ((1, 1, 5, 8), (2, 7, 1, 6), (1, 9, 11, 130)):
        rois = torch.as_tensor(
            np.stack([flagship_rois(rng, 17, shape[1] * 16, shape[2] * 16)
                      for _ in range(shape[0])]), device=dev)
        g = torch.as_tensor(rng.randn(shape[0], 17, 7, 7, shape[3]).astype(np.float32),
                            device=dev)
        check(g, rois, shape, 7, f"{shape} x 17 ROIs P=7 f32")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": times[2][0], "plain_ms": times[2][1]}


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
    from unit_tpu_torch.ops.nms_cuda import nms_sorted_mask_cuda
    from unit_tpu_torch.ops.roi_align_cuda import roi_align_backward_cuda, roi_align_cuda
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
    roi_align_cuda.launches = 0
    roi_align_backward_cuda.launches = 0
    nms_sorted_mask_cuda.launches = 0
    times = [step("timed") for _ in range(TRAIN_STEPS)]
    launches = {"roi_align_fwd": roi_align_cuda.launches,
                "roi_align_bwd": roi_align_backward_cuda.launches,
                "nms_mask": nms_sorted_mask_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    imgs = 2 * strong[0]["image"].shape[0]
    log(f"[7] {TRAIN_STEPS} timed steps: median {med:.2f} ms (min {min(times):.2f}, max "
        f"{max(times):.2f}), {1e3 * imgs / med:.2f} images/s ({imgs} per step), peak "
        f"device memory {peak / 2**20:.1f} MiB")
    log(f"[7] launches during the timed steps: {launches}")
    want = {"roi_align_fwd": 2 * TRAIN_STEPS, "roi_align_bwd": 2 * TRAIN_STEPS,
            "nms_mask": 4 * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"the train path did not run K1 x2, K2 x2, K3 x4 per step: "
                             f"{launches}")
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
    phase_e2e(cfg, args.seed)
    phase_whole_path(cfg, args.seed)
    k2 = phase_k2(rng)
    launches = phase_train(cfg, args.seed)
    phase_train_whole_path(cfg, args.seed)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = [
        dict(name="roi_align_fwd", route="cuda", source="unit_tpu_torch/csrc/roi_align_fwd.cu",
             replaces="unit_tpu/ops/roi_align_pallas.py:230",
             launches=launches["roi_align_fwd"], **k1),
        dict(name="roi_align_bwd", route="cuda", source="unit_tpu_torch/csrc/roi_align_bwd.cu",
             replaces="unit_tpu/ops/roi_align_pallas_bwd.py:564",
             launches=launches["roi_align_bwd"], **k2),
        dict(name="nms_mask", route="cuda", source="unit_tpu_torch/csrc/nms_mask.cu",
             replaces="unit_tpu/ops/nms_pallas.py:115",
             launches=launches["nms_mask"], **k3),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
