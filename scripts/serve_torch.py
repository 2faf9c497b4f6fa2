#!/usr/bin/env python
"""Serve a trained detector of unit_tpu_torch over HTTP (twin of scripts/serve.py).

    # a live model from a training run or converted weights:
    python scripts/serve_torch.py --config-file configs/VOC/VOC-RCNN-101-C4-split1.yaml \
        --port 8080 [--batch-size 4] MODEL.WEIGHTS runs/base/best/model

    # a torch.export artifact of scripts/export_model_torch.py (the weights
    # are the artifact's own):
    python scripts/serve_torch.py --config-file ... --artifact model.pt2.pkl

    curl -X POST --data-binary @image.jpg localhost:8080/predict

Endpoints: POST /predict (image bytes -> JSON detections in original-image
coordinates), GET /healthz, GET /metadata.  The model runs on the card;
``--device cpu`` asks for the CPU on purpose.  SIGTERM or SIGINT finishes the
requests in flight and exits.
"""

import argparse
import os
import signal
import sys
import threading
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def class_names_of(cfg):
    """The class names of the first test dataset that has them, or None."""
    from unit_tpu_torch.data import MetadataCatalog

    for name in cfg.DATASETS.TEST or ():
        names = MetadataCatalog.get(name).get("thing_classes")
        if names:
            return list(names)
    return None


def build_model(cfg, device):
    """The config's detector on ``device`` with MODEL.WEIGHTS and the GloVe
    embeddings loaded, in evaluation mode."""
    import torch

    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.models import WSRCNN, ModelConfig

    model = WSRCNN(ModelConfig.from_cfg(cfg), generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    runner.load_initial_weights(cfg, model)
    return model.eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--artifact", default="", help="a torch.export artifact")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="micro-batch concurrent requests into one device call of up to "
                         "this size (with --artifact the artifact's batch size holds)")
    ap.add_argument("--batch-wait-ms", type=float, default=5.0,
                    help="the longest a request waits for its micro-batch to fill")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.serving import DetectionServer, DetectionService, load_exported

    device = runner.resolve_device(args.device)
    cfg = runner.setup(types.SimpleNamespace(config_file=args.config_file, opts=args.opts,
                                             data_root=None))
    class_names = class_names_of(cfg)
    if args.artifact:
        exported = load_exported(args.artifact)
        if exported.device.type != device.type:
            raise ValueError(f"{args.artifact} runs on {exported.device.type}, not on "
                             f"--device {device.type}")
        service = DetectionService(cfg, exported=exported, class_names=class_names,
                                   batch_wait_ms=args.batch_wait_ms)
        metadata = dict(exported.meta)
    else:
        service = DetectionService(cfg, build_model(cfg, device), class_names=class_names,
                                   batch_size=args.batch_size,
                                   batch_wait_ms=args.batch_wait_ms)
        metadata = {"config": args.config_file, "weights": cfg.MODEL.WEIGHTS,
                    "num_classes": int(cfg.MODEL.ROI_HEADS.NUM_CLASSES),
                    "class_names": class_names, "batch_size": args.batch_size,
                    "device": str(device)}
    if not args.no_warmup:
        print("warming up (both canvas orientations, every batch size)...", flush=True)
        service.warmup()
    server = DetectionServer(service, host=args.host, port=args.port, metadata=metadata)

    def stop(signum, frame):
        print(f"signal {signum}: shutting down", flush=True)
        # shutdown() waits for serve_forever to return: call it from another thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGINT, stop)
    print(f"serving on {args.host}:{server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
