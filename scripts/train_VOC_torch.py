#!/usr/bin/env python
"""Base training CLI of the PyTorch/CUDA port (twin of scripts/train_VOC.py).

Usage:
  python scripts/train_VOC_torch.py --config-file configs/VOC/VOC-RCNN-101-C4-split1.yaml \
      [--eval-only] [--resume] [--device cuda|cpu] [--data-root DIR] SOLVER.BASE_LR 0.02 ...

The model runs on one NVIDIA GPU; ``--device cpu`` asks for the CPU on purpose.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from unit_tpu_torch.engine.runner import default_argument_parser, run  # noqa: E402

if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    run(args)
