#!/usr/bin/env python
"""k-shot fine-tuning CLI of the PyTorch/CUDA port (twin of scripts/finetune_VOC.py).

Usage:
  python scripts/finetune_VOC_torch.py \
      --config-file configs/VOC/FT/10_shot/VOC-RCNN-101-C4-split1-ft.yaml \
      [--eval-only] [--resume] [--device cuda|cpu] [--data-root DIR] \
      MODEL.WEIGHTS <base run>/best/model ...

The config's SupervisedDetectorOutputsFineTune head selects TrainerFineTune
(the k-shot strong stream alone, the base->novel transfer applied in
training); MODEL.WEIGHTS names a base run's best snapshot, which the port
writes as ``best/model.pt``.  The model runs on an NVIDIA GPU; ``--device
cpu`` asks for the CPU on purpose.

Data parallelism, one process a rank: ``--num-gpus N`` spawns N ranks on
cards 0..N-1 (NCCL); with ``--device cpu``, N CPU ranks (gloo).  Under
torchrun, ``--dist`` joins the group it describes:
  torchrun --nproc_per_node N scripts/finetune_VOC_torch.py --dist --config-file ...
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
