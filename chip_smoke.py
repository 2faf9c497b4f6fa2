#!/usr/bin/env python3
"""Build and drive unit_tpu_torch's serving path once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for the
sm_90a kernels) and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and the script exits non-zero):
  0  environment: card, power limit, torch/CUDA/nvcc versions, PyYAML
  1  build the two CUDA kernels from unit_tpu_torch/csrc with nvcc, timed
  2  K1 ROIAlignV2 forward vs its plain version at the flagship shapes
  3  K3 greedy-NMS mask vs its plain version (RPN, final and degenerate cases)
  4  end to end: the flagship VOC R-101-C4 detector at full width, random
     seeded weights, bf16, served by DetectionService.detect_array in both
     canvas orientations; launch counters prove the path ran the kernels
  5  whole-path kernel check in f32 (TF32 off): predict_raw with the kernels
     vs with the plain versions
The last three lines are the card (nvidia-smi), one JSON object describing
the kernels, and {"ok": true, "device": {...}}.  Without a CUDA device, or
without the unit_tpu_torch package beside it, the script fails before any
result is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    roi_align_cuda._lib()
    nms_cuda._lib()
    log(f"[1] built both kernels in {time.perf_counter() - t0:.1f} s")
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


def profile_request(svc, image):
    """Where one request's time goes: torch.profiler over one more request."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.detect_array(image)
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the CPU-side aten ops carry
    # the same device time again
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    log(f"[4] profiled request: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%), "
        f"{n_ops} device ops")
    for ms, count, key in sorted(rows, reverse=True)[:15]:
        log(f"[4]   {ms:9.3f} ms  x{count:<5d} {key[:110]}")
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
    launches = phase_e2e(cfg, args.seed)
    phase_whole_path(cfg, args.seed)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = [
        dict(name="roi_align_fwd", route="cuda", source="unit_tpu_torch/csrc/roi_align_fwd.cu",
             replaces="unit_tpu/ops/roi_align_pallas.py:230",
             launches=launches["roi_align_fwd"], **k1),
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
