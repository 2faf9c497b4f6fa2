#!/usr/bin/env python
"""Base training CLI of the PyTorch/CUDA port (twin of scripts/train_VOC.py).

Usage:
  python scripts/train_VOC_torch.py --config-file configs/VOC/VOC-RCNN-101-C4-split1.yaml \
      [--eval-only] [--resume] [--device cuda|cpu] [--data-root DIR] SOLVER.BASE_LR 0.02 ...

The model runs on an NVIDIA GPU; ``--device cpu`` asks for the CPU on purpose.

Data parallelism, one process a rank: ``--num-gpus N`` spawns N ranks on
cards 0..N-1 (NCCL); with ``--device cpu``, N CPU ranks (gloo).  Under
torchrun, ``--dist`` joins the group it describes:
  torchrun --nproc_per_node N scripts/train_VOC_torch.py --dist --config-file ...
SOLVER.IMS_PER_BATCH is the global batch, split over the ranks.
Pipeline parallelism: ``--num-gpus N TPU.PP True TPU.PP_STAGES S
TPU.GRAD_ACCUM A`` (A >= 2) runs N / S data ranks of S stage ranks each;
IMS_PER_BATCH is then split over the N / S data ranks, and
SOLVER.REFERENCE_WORLD_SIZE scales the config by N, as unit_tpu does.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from unit_tpu_torch.engine.runner import default_argument_parser, run  # noqa: E402

if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    run(args)
