"""The plain reference of ``voc-r101-c4`` (configs/VOC/VOC-RCNN-101-C4-split1.yaml,
UniT, arXiv:2006.07502): WeaklySupervisedRCNNNoMeta on ResNet-101-C4.

    backbone  stem (7x7/2 conv, 3x3/2 max pool), res2-res4 bottlenecks
              (3, 4, 23) at stride 16, a frozen batch norm after each
              convolution; the stem and res2 frozen
    RPN       3x3 conv 1024 -> 1024, 15 anchors (5 sizes x 3 ratios): 15
              objectness logits and 60 deltas; 12000 -> 2000 proposals an
              image by NMS at IoU 0.7
    ROI heads 512 sampled proposals a strong image (25% foreground),
              ROIAlignV2 14 x 14 from the stride-16 map, two Res5 heads
              (MULTI_BOX_HEAD): the box head for the supervised deltas, the
              weak head frozen on the strong ROIs and trained on the weak
              image's top 512 proposals; MIL + three OICR refinements on the
              weak stream; cross-entropy + L1 on the strong stream on top of
              the frozen mean OICR scores, the 5 novel classes masked
    update    SGD with momentum, the gradient clipped to global norm 1.0

All of it is ``wsod``; the loader's batches are made again by
``ref_decode``."""

import ref_decode  # noqa: F401
from wsod import *  # noqa: F401,F403
