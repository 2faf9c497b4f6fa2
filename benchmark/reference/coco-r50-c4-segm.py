"""The plain reference of ``coco-r50-c4-segm``
(configs/COCO/COCO-RCNN-50-C4-split1-segm.yaml, UniT, arXiv:2006.07502):
WeaklySupervisedRCNNNoMeta with masks on ResNet-50-C4.

    backbone  as ResNet-101-C4 with 6 res4 blocks instead of 23
    RPN       as the flagship's
    ROI heads one Res5 head (Res5BoxHeadWithMask) for the strong ROIs and
              the weak stream; the mask head: a 2x2 stride-2 transposed
              convolution 2048 -> 256 of the 7 x 7 Res5 map, ReLU, a 1x1
              convolution to 80 class masks of 14 x 14, a per-pixel binary
              cross-entropy over the first 128 (foreground) slots of each
              image against the GT masks cropped to the ROIs; 20 novel
              classes masked
    update    SGD with momentum, the gradient clipped to global norm 1.0

All of it is ``wsod``; the loader's batches are made again by
``ref_decode``."""

import ref_decode  # noqa: F401
from wsod import *  # noqa: F401,F403
