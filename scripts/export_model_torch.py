#!/usr/bin/env python
"""Export a trained detector of unit_tpu_torch to a torch.export artifact
(twin of scripts/export_model.py).

    python scripts/export_model_torch.py --config-file configs/VOC/VOC-RCNN-101-C4-split1.yaml \
        --out model.pt2.pkl [--batch-size 4] MODEL.WEIGHTS runs/base/best/model
    python scripts/export_model_torch.py --describe model.pt2.pkl

The artifact holds one program per test-canvas orientation at one batch
size, with the weights as the programs' own state, exported on the device it
will run on (the card unless ``--device cpu``).  ``--describe`` prints an
artifact's metadata.
"""

import argparse
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)  # serve_torch
sys.path.insert(0, os.path.join(HERE, ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-file", default="")
    ap.add_argument("--out", default="model.pt2.pkl")
    ap.add_argument("--describe", default="", help="print an artifact's metadata")
    ap.add_argument("--batch-size", type=int, default=1,
                    help="export fixed-batch programs for micro-batched serving")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from unit_tpu_torch.serving import describe, export_predict

    if args.describe:
        print(describe(args.describe))
        return
    if not args.config_file:
        ap.error("--config-file is required unless --describe is given")

    from serve_torch import build_model, class_names_of
    from unit_tpu_torch.engine import runner

    device = runner.resolve_device(args.device)
    cfg = runner.setup(types.SimpleNamespace(config_file=args.config_file, opts=args.opts,
                                             data_root=None))
    meta = export_predict(cfg, build_model(cfg, device), args.out,
                          class_names=class_names_of(cfg), batch_size=args.batch_size)
    size_mib = os.path.getsize(args.out) / 2**20
    print(f"exported {meta['canvases']} ({meta['platforms']}, batch {meta['batch_size']}) "
          f"-> {args.out} ({size_mib:.1f} MiB)")


if __name__ == "__main__":
    main()
