"""Shared by the benchmark's CPU tests: the import paths of a run, and each
cell at a tiny size (ResNet-26 with 16-channel res2, 60x80 images on 96 x
128 canvases, 2 + 2 images a step, a few dozen proposals) on the CPU with
the plain versions of the kernels, in float32."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(BENCH, "reference"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"MODEL.RESNETS.DEPTH": 26, "MODEL.RESNETS.RES2_OUT_CHANNELS": 16,
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 300, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 48,
        "MODEL.RPN.PRE_NMS_TOPK_TEST": 300, "MODEL.RPN.POST_NMS_TOPK_TEST": 48,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32, "TPU.COMPUTE_DTYPE": "float32",
        "INPUT.MIN_SIZE_TRAIN": "(64, 96)", "INPUT.MAX_SIZE_TRAIN": 128,
        "INPUT.MIN_SIZE_TEST": 96, "INPUT.MAX_SIZE_TEST": 128, "SOLVER.IMS_PER_BATCH": 2,
        "TPU.MAX_GT_BOXES": 8, "MODEL.ROI_HEADS.SCORE_THRESH_TEST": 0.0}
SHAPES = [[60, 80], [80, 60]]


def tiny_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at the tiny size."""
    import torch

    from harness import common

    torch.set_num_threads(2)
    cell = common.Cell(common.load_json(ROOT, "BENCHMARK.json"), name)
    cell.config["changed"].update(TINY)
    cell.mix.update(images=8, shapes={"VOC": SHAPES, "COCO": SHAPES}, warmup_max_steps=6)
    return cell
