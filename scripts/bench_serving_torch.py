#!/usr/bin/env python3
"""Serving throughput of unit_tpu_torch: DetectionService at batch 1 against
micro-batched batch N under concurrent clients (twin of scripts/bench_serving.py).

Times the whole request path (decode in ``bytes`` mode -> test-time resize to
the canvas -> device predict -> packed device-to-host copy -> detections in
the original frame) with C client threads, and prints requests/s and the p50
and p99 latency of each service.  In ``bytes`` mode a JPEG is decoded and
resized by the port's C loader (data/native.py) where it builds, with PIL
decoding where the host has no libjpeg; the last line's ``decode`` says
which.  ``--uint8-wire`` sets TPU.HOST_TRANSFER_UINT8 (uint8 canvases, 4x
fewer bytes to upload).

    python3 scripts/bench_serving_torch.py [--config-file YAML] [--requests 64]
        [--clients 8] [--batch 4] [--mode bytes|array|both] [--depth 50|101]
        [--min-size S --max-size M] [--weights PATH] [--images-dir DIR]
        [--uint8-wire] [--device cuda|cpu] [KEY VALUE ...]

The config (the flagship's by default) stands as its YAML gives it: a flag
changes a value only when it is passed.  Without ``--weights`` the weights
are seeded and FrozenBN is calibrated as chip_smoke.py does (random
statistics give no proposals).  Requests are seeded noise images of a VOC
image's size (375x500), alternating landscape and portrait, or the JPEGs of
``--images-dir``; the micro-batcher waits up to 10 ms for a group, as
unit_tpu's bench does.  Runs on the card unless ``--device cpu`` is given;
the last line is one JSON object with the numbers.
"""

import argparse
import concurrent.futures as cf
import io
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import numpy as np  # noqa: E402

FLAGSHIP = HERE.parent / "configs" / "VOC" / "VOC-RCNN-101-C4-split1.yaml"
VOC_IMAGE = (375, 500)
BATCH_WAIT_MS = 10.0
SEED = 0


def run(service, requests, clients, mode):
    """-> (req/s, p50 ms, p99 ms, latencies ms, results) of ``requests``
    under ``clients`` concurrent callers."""
    call = service.detect_bytes if mode == "bytes" else service.detect_array
    lat = []

    def timed_call(r):
        t = time.perf_counter()
        out = call(r)
        lat.append((time.perf_counter() - t) * 1e3)
        return out

    with cf.ThreadPoolExecutor(clients) as pool:
        t0 = time.perf_counter()
        results = list(pool.map(timed_call, requests))
        dt = time.perf_counter() - t0
    if not all(isinstance(r, list) for r in results):
        raise TypeError("a request returned no list of detections")
    ordered = sorted(lat)
    p50 = ordered[len(ordered) // 2]
    p99 = ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]
    return len(requests) / dt, p50, p99, lat, results


def bench_cfg(args):
    """The benchmark's config: the YAML as it is, then only the flags given."""
    from unit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.depth is not None:
        cfg.MODEL.RESNETS.DEPTH = args.depth
    if args.min_size is not None:
        cfg.INPUT.MIN_SIZE_TEST = args.min_size
    if args.max_size is not None:
        cfg.INPUT.MAX_SIZE_TEST = args.max_size
    cfg.MODEL.WEIGHTS = args.weights
    if args.uint8_wire:
        cfg.TPU.HOST_TRANSFER_UINT8 = True
    if args.opts:
        cfg.merge_from_list(args.opts)
    return cfg


def make_requests(args, rng):
    """{mode: [request, ...]}: float BGR arrays and their JPEG bytes."""
    from PIL import Image

    if args.images_dir:
        files = sorted(Path(args.images_dir).rglob("*.jpg"))
        if not files:
            raise FileNotFoundError(f"no JPEGs under {args.images_dir}")
        jpegs = [files[i % len(files)].read_bytes() for i in range(args.requests)]
        arrays = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB"), np.float32)[:, :, ::-1]
                  for b in jpegs]
        return {"bytes": jpegs, "array": arrays}
    h, w = VOC_IMAGE
    shapes = ((h, w), (w, h))
    arrays = [(rng.rand(*shapes[i % 2], 3) * 255).astype(np.float32)
              for i in range(args.requests)]
    jpegs = []
    for a in arrays:
        buf = io.BytesIO()
        Image.fromarray(a[:, :, ::-1].astype(np.uint8)).save(buf, format="JPEG", quality=90)
        jpegs.append(buf.getvalue())
    return {"bytes": jpegs, "array": arrays}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", default=str(FLAGSHIP))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--min-size", type=int, default=None)
    ap.add_argument("--max-size", type=int, default=None)
    ap.add_argument("--mode", choices=("bytes", "array", "both"), default="both",
                    help="bytes: encoded requests through detect_bytes (a JPEG "
                         "decoded and resized by the C loader where it builds, "
                         "else PIL + numpy); array: decoded arrays (numpy resize)")
    ap.add_argument("--weights", default="",
                    help="MODEL.WEIGHTS for trained weights (default: seeded, FrozenBN "
                         "calibrated)")
    ap.add_argument("--images-dir", default="", help="JPEGs for the request stream (cycled)")
    ap.add_argument("--uint8-wire", action="store_true",
                    help="set TPU.HOST_TRANSFER_UINT8: uint8 canvases, 4x fewer bytes "
                         "to upload, at most 0.5 off")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    import torch

    from microbench_torch import chip_smoke_here
    from unit_tpu_torch.data import native
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.engine.runner import load_initial_weights, resolve_device
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.serving import DetectionService

    dev = resolve_device(args.device)
    cfg = bench_cfg(args)
    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    load_initial_weights(cfg, model)
    rng = np.random.RandomState(SEED)
    if not args.weights:
        s = prepare_test_image((rng.rand(375, 500, 3) * 255).astype(np.float32),
                               TransformConfig.test_from_cfg(cfg))
        chip_smoke_here().calibrate_frozen_bn(
            model, torch.as_tensor(s["image"][None], device=dev),
            torch.as_tensor(s["image_size"][None], device=dev))
    requests = make_requests(args, rng)
    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "config": args.config_file, "depth": int(cfg.MODEL.RESNETS.DEPTH),
           "canvas": list(TransformConfig.test_from_cfg(cfg).canvas),
           "compute_dtype": cfg.TPU.COMPUTE_DTYPE, "clients": args.clients,
           "requests": args.requests, "uint8_wire": bool(cfg.TPU.HOST_TRANSFER_UINT8),
           "decode": native.STATUS.get("decode") if native.available() else "PIL (no C loader)"}
    for batch in (1, args.batch):
        svc = DetectionService(cfg, model, batch_size=batch, batch_wait_ms=BATCH_WAIT_MS)
        svc.warmup()  # both orientations, every batch size a group can take
        for mode in (("bytes", "array") if args.mode == "both" else (args.mode,)):
            run(svc, requests[mode][: args.clients * 2], args.clients, mode)
            rps, p50, p99, *_ = run(svc, requests[mode], args.clients, mode)
            label = "batch 1" if batch == 1 else f"batch {batch} (micro)"
            print(f"[{mode}] c={args.clients} {label}: {rps:.2f} req/s  p50 {p50:.1f} ms  "
                  f"p99 {p99:.1f} ms", flush=True)
            out[f"{mode}_batch{batch}"] = {"req_per_s": rps, "p50_ms": p50, "p99_ms": p99}
        svc.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
