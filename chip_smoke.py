#!/usr/bin/env python3
"""Build and drive unit_tpu_torch's serving, training and run-loop paths on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card (an H100 for the
sm_90a kernels) and nvcc:

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and the script exits non-zero):
  0  environment: card, power limit, torch/CUDA/nvcc versions, PyYAML, PIL
  1  build the four CUDA kernels from unit_tpu_torch/csrc, one nvcc each,
     all started together, timed
  2  K1 ROIAlignV2 forward vs its plain version at the flagship shapes: a
     request's, a train step's (uniform, piled and in one band) and a
     fine-tune step's (8 images) ROIs, two
     launches bit-identical, kernel, plain and bound times, the wrapper's
     host time a call
  3  K3 greedy-NMS mask vs its plain version, bit-identical: the RPN's test
     shape (6000 -> 1000), the final detections (20000 class-offset boxes ->
     100), zero-area rows and duplicates, cap 1 and a cap above N, a batch of
     images with different valid counts (one with none), and the training
     shape in ONE launch (4 images x 12000 -> 2000) in three layouts
     (clustered, sparse, dense: every row walked); two launches bit-identical;
     kernel, plain and bound times, the IoU tests each layout needs, and the
     wrapper's host time a call
  4  serving end to end: the flagship VOC R-101-C4 detector at full width,
     random seeded weights, bf16, served by DetectionService.detect_array in
     both canvas orientations; launch counters prove every request ran K1
     x1, K3 x2 (RPN and final NMS) and K4 x114 (one launch per FrozenBN); the
     same requests again with the plain epilogue, in turns
  5  whole serving path in f32 (TF32 off): predict_raw with the kernels
     (K1, K3, K4) vs with the plain versions
  6  K2 ROIAlignV2 backward vs its plain version at the flagship train-step
     shapes, f32 and bf16, with uniform ROIs, ROIs piled as a train step lays
     them out and ROIs in one band (row lists of several segments); two
     launches bit-identical; the wrapper's host time and scratch bytes
  7  training end to end: TrainerNoMeta takes 2 warm-up and 8 timed steps of
     the flagship recipe at full width (2 strong + 2 weak images per step,
     canvases alternating 800x1344 / 1344x800, bf16) with build_optimizer's
     SGD (gradients clipped: the weights are random); launch counters prove
     every step ran K1 x2, K2 x2, K3 x1 (one launch for the step's 4 images)
     and K4 once per FrozenBN forward and
     once per differentiated FrozenBN backward; 1 + 4 steps a turn with the
     plain epilogue and K4, in turns; then TPU.REMAT_BACKBONE on and off in
     turns (1 + 4 steps each, on, off, on, off): step medians, peak memory,
     and with the key on K4 (124 + 94) + 103 a step (the backbone's
     forwards again in backward)
  8  whole train path in f32 (TF32 off): train_losses + backward with the
     kernels vs with the plain versions, same weights and generator seed;
     then with TPU.REMAT_BACKBONE on against off (losses 1e-5, gradients
     phase 8's bound, the launches: the backbone's K4 forwards twice)
  9  K4 fused FrozenBN + residual + ReLU epilogue vs its plain version,
     forward and backward, bf16 and f32, at the flagship shapes and two narrow
     ones (bit-identical); times beside the four-op chain it replaces and the
     bound of the bytes it must move
 10  the run loop at full width and depth: engine.runner.run on a synthetic
     VOC devkit (XML and image sets on disk, images from a seeded loader):
     6 steps with checkpoints and evaluations every 3; a checkpoint written
     synchronously and in the background (the ms save() takes to return and
     to land, the state changed in place as it returns, the landed file
     equal to the synchronous write), a resume from step 3, --eval-only from
     step 6, one evaluation with TPU.FOLD_BN_AT_EVAL, and 14 steps without
     hooks for the loader's steady rate at metrics_pipeline_depth 0 and 8
     in turns (0, 8, 0, 8): every step's losses bit-identical, launches a
     step equal, peak memory within 2%, the wall time of a window of steps
     that ends in a drain a step, and the device's busy share of the last
     turns' profiled window (the turns leave runner.run's final evaluation
     out: no turn reads it)
 11  k-shot fine-tuning: engine.runner.run on the shipped 10-shot split1
     fine-tune recipe (8 strong images a step), warm-started from phase 10's
     best/model as the recipe spells it, 6 steps with checkpoints and
     evaluations every 3; every frozen tensor bit-identical to the snapshot,
     the RPN and *_ft heads moved, no K2 or K4 backward launched; 2 warm-up +
     8 timed steps with launch counts (K1 x1, K3 x1 for 8 images, K4 forward
     only) and one profiled step; the f32 fine-tune path with the kernels vs
     the plain versions
 12  COCO detection and instance segmentation: the R-50-C4 segm recipe at
     full width (80 classes, the mask head): 4 served requests (K1 x2 with
     the mask path's pass over the final detections, K3 x2, K4 x63 each), K1
     against its plain version at the mask path's own input, one profiled
     request; the f32 predict with masks, kernels vs plain; 2 + 6 timed
     train steps with gt_masks (K1 2, K2 2, K3 1, K4 63 + 52) and one
     profiled; the f32 train path (loss_mask included) kernels vs plain;
     engine.runner.run on a shapes-COCO devkit (JPEGs and polygons from
     scripts/make_shapes_coco_torch.py): the segm recipe 4 steps with
     checkpoints and evaluations every 2 (bbox and segm AP), the segm-ft
     recipe from its best/model 4 steps (frozen tensors and the absent
     weak_box_head bit-identical, K2 0, K4 backward > 0), 1 + 3 timed
     fine-tune steps (K1 1, K3 1 for 8 images, K4 63 + 10) and one profiled
 13  the weak detector's alternatives at the flagship's full width: the PCL
     recipe (2 + 6 timed train steps, K1 2, K2 2, K3 1, K4 124 + 103 a step;
     the PCL losses alone against the OICR losses on one step's inputs, under
     CUDA sync debug mode "error"; the f32 PCL train path kernels vs plain);
     WeakRCNN served through make_predict_fn (predict_weak_only: K1 1, K3 2,
     K4 104 a request) and its f32 request path kernels vs plain;
     TrainerOnlyWeak 2 + 4 steps (K1 1, K2 1, K3 1 for the 2 weak images);
     WeaklySupervisedRCNNRPN 2 + 4 steps (K1 3, K2 2, K3 4 launches for 8
     images) and K3 against its plain version at the self-training
     predict's 2 x 6000 -> 1000; engine.runner.run with
     TrainerOnlyWeakFineTune on phase 10's devkit, 3 steps and an evaluation
 14  the meta recipe (VOC-RCNN-101-C4-split1-meta.yaml) at the flagship's
     full width: Trainer 2 + 6 timed steps of 2 strong + 2 weak images and
     15 classes x 5 support shots at 224, all in pinned memory (K1 3, K2 2,
     K3 1, K4 238 + 123 a step), the rank losses' underflow constants exact,
     one profiled step; the f32 meta train path kernels vs plain; K1 against
     its plain version at the support shapes ([75,14,14,1024] x 1 ROI, the
     step's own shots, and an evaluation's [750,14,14,1024] x 1);
     engine.runner.run with Trainer on phase 10's devkit: 2 steps, a
     checkpoint at 1, the evaluation with its support precompute (10 shots a
     class; the recipe's 50 make K1's [750,14,14,1024]), and a resume from
     step 1
 15  test-time augmentation (TEST.AUG at its defaults: scales 480-1200,
     MAX_SIZE 2000, flip) on the flagship at full width: one 600x800 image's
     f32 path kernels vs plain (identical proposals, phase 5's bounds); in
     bf16 its launches (K1 5, one a group of a scale's flip pair; K3 2; K4
     94 + 5 x (94 + 20)), time, memory and profile; K1 at the five group
     shapes and K3 at the final NMS on that image's own inputs;
     engine.runner.run --eval-only with TTA from phase 10's checkpoint on a
     2-image devkit (seconds per image, the loader's wait apart); precise_bn
     over 4 pre-made batches with K4 and with the plain epilogue
     (bit-identical buffers), then run with
     TEST.PRECISE_BN (NUM_ITER 4): the checkpoint holds the refreshed
     statistics; run with TPU.PROFILE_START_STEP 2: its trace names K1-K4
 16  the note recipe (COCO-RCNN-50-C4-split1-note.yaml: InceptionResNetV2 to
     block17, 1088 channels, and the InceptionResNetV2 tail as the box head
     over 17x17 ROIs, 80 classes, no FrozenBN) at full width and depth: 4
     served requests of 480x640 / 640x480 (K1 1, K3 2, K4 0 each), K1 at a
     request's own input, one profiled request; the f32 predict path kernels
     vs plain; TrainerNoMeta 2 + 6 timed steps of 2 strong + 2 weak images on
     608x1344 canvases in both orientations (K1 2, K2 2, K3 1, K4 0 a step),
     one profiled, then one step at the recipe's IMS_PER_BATCH (8 strong + 8
     weak images) with its peak memory; the f32 train path kernels vs plain;
     K1 and K2 against their plain versions at the step's own inputs (P = 17,
     C = 1088, f32 and bf16) and K3 at its RPN's; engine.runner.run on phase
     12's shapes-COCO devkit: 4 steps, a checkpoint and an evaluation at 2
     (COCO bbox AP), a resume from step 2
 17  the dock recipe (COCO-VGG-CNN-F-split1-dock.yaml: VGG-CNN-F with Caffe
     LRN, ROIPool at 6x6, the VGG fc head 9216 -> 4096 -> 4096 with dropout in
     training, 80 classes, no FrozenBN) at full width with precomputed
     MCG-style proposals (scripts/make_shapes_proposals_torch.py): 4 requests
     of 480x640 / 640x480 with 5000 proposals each through make_predict_fn (K3
     1, the final NMS, and no other kernel), K3 at a request's own final NMS,
     one profiled request; the f32 predict path kernels vs plain (identical
     detections); TrainerNoMeta 2 + 6 timed steps of 2 + 2 images at the
     largest train size (a 1200-pixel short side in the 1216x2016 canvas)
     with proposals for both streams (no kernel launched: no RPN), one
     profiled, one step at IMS_PER_BATCH 8 + 8; the YAML alone (no proposal
     file): the RPN over VGG-CNN-F beside R12's all-invalid weak slots, 1 + 2
     steps (K3 1 a step), 2 requests (K3 2 each) and the f32 train path
     kernels vs plain; ROIPool's forward and backward at the step's own inputs
     (its backward twice bit-identical); engine.runner.run on phase 12's
     shapes-COCO devkit with proposal pickles: 4 steps, a checkpoint and an
     evaluation at 2, a resume from 2; one image under TEST.AUG.ENABLED with
     proposals (K3 1)
 18  the serving surface at the flagship's full width (bf16): 16 seeded
     requests of 375x500 / 500x375 under 8 client threads
     (scripts/bench_serving_torch.py's load generator) through
     DetectionService at batch 1 and micro-batched at 4 (wait 10 ms): req/s,
     p50/p99, each device call's batch and its launches (K1 1, K3 1 + b, K4
     114 a call); micro-batched against batch 1 in f32 with TF32 off (counts
     and classes equal, boxes 1e-2 px, scores 1e-4); torch.export artifacts
     at batch 4 (landscape) and at batch 1 (portrait): export seconds, MiB,
     each artifact against the live predict (one batch, one portrait request)
     and its launches, the batch artifact served through the service; the
     dock recipe's artifact with 5000 proposals on one request against
     make_predict_fn (identical; K3 1, no K1, K2 or K4) and refused by the
     service; DetectionServer on 127.0.0.1
     (/healthz, /metadata, 4 concurrent JPEG POSTs, 400, 404);
     scripts/serve_torch.py --artifact and scripts/export_model_torch.py
     --describe as subprocesses
 19  the flagship learns: a shapes-VOC devkit (scripts/make_shapes_voc_torch.py:
     JPEGs of the 20 classes as (shape, hue) pairs), engine.runner.run on
     the recipe from random weights (MODEL.WEIGHTS "", FREEZE_AT 0, LR 0.002
     with 100 warm-up steps, 320-pixel INPUT sizes: the accuracy pipeline's
     settings) for 90 steps of 4 + 4 images, one checkpoint and one
     evaluation; the median total_loss of the last 20 steps under 0.7x that
     of the first 20, loss_rpn_cls and loss_im_cls lower, every loss finite
     (AP reported, not gated); on the trained checkpoint: the proposals an
     image at test settings against random weights', the f32 predict and
     train paths kernels vs plain, bf16 against f32 on the test images, a
     trained step of 2 + 2 images at 800x800 under the recipe's solver (K1 2,
     K2 2, K3 1, K4 124 + 103) and K3 at that step's own RPN input (4 x
     12000 -> 2000) bit-identical to its plain version, timed beside phase
     3's three synthetic layouts
 20  the host wire: (a) build the C host loader (unit_tpu_torch/csrc/
     dataloader.cc with g++; libjpeg decodes where the host has jpeglib.h,
     else PIL) and print how; (b) prepare_image, prepare_image_mem and
     prepare_batch (8 threads) bit-identical on 16 VOC-sized JPEGs, the C
     canvas within 2^-8 of the numpy path's with equal dims and scale; (c)
     host ms an image, C against PIL + numpy, to the 800x1344 canvases; (d)
     engine.runner.run at full width on a devkit of JPEG files (no
     image_loader), 12 steps through the C loader at metrics_pipeline_depth
     0 and 8 in turns (0, 8, 0, 8; gated as phase 10's; no final
     evaluation), then the same at 8 with its evaluation through PIL (the
     script patches data.native.available): windowed step ms and data-wait
     medians, every step K1 2, K2 2, K3 1, K4 124 + 103; (e)
     detect_bytes on 16 JPEGs
     under 8 clients at batch 1 and micro-batched at 4, C against PIL: req/s,
     p50, images a device call; (f) TPU.HOST_TRANSFER_UINT8: served batch-4
     requests (uint8 canvases, launches as phase 18's) and 2 flagship train
     steps on uint8 batches (phase 7's launches, finite losses), upload MiB
     and ms against the f32 wire
 21  data parallelism (parallel.launch; NCCL refuses two ranks on one card, so
     two ranks share card 0 over gloo): (a) the flagship at full width at the
     recipe's global batch, 4 + 4 images a rank, 1 warm-up + 3 timed steps:
     per rank the step median, the gradient all-reduce's ms a step and the
     peak memory, every rank's launches (K1 2, K2 2, K3 1, K4 124 + 103 a
     step), one state on both ranks (a hash), finite losses; (b) f32 with
     TF32 off and every candidate kept: one step at world 2, 1 + 1 images a
     rank, against one process on the 2 + 2 global batch (losses 1e-4,
     gradients phase 8's bound); (c) engine.runner.run at world 2 on phase
     20's devkit of JPEG files through the C loader (in (a)'s and (b)'s
     spawn): 4 steps, a checkpoint and
     an evaluation at 2 and 4, the gathered AP against a one-process
     --eval-only of the step-4 checkpoint (1e-6), a resume from step 2; (d)
     --dist at world 1 over NCCL from torchrun's environment: 2 steps, their
     launches, finite losses, one NCCL all-reduce; (e) in (a)'s spawn, 2 + 2
     images a rank at metrics_pipeline_depth 8 with a stop asked on rank 1
     alone after step 1: both ranks stop after step 9, the first resolution,
     with the same losses
 22  FSDP and TP (parallel.mesh, two gloo ranks sharing card 0, the ranks of
     phase 21's spawn: phases 21 and 22 share one, phase_multi_rank): (a) FSDP
     (fully_shard; gloo stages its collectives through the host) at world
     2, 4 + 4 images a rank, 1 warm-up + 3 steps: per rank the step
     median, peak memory, launches (K1 2, K2 2, K3 1, K4 124 + 103 a step),
     res4's first conv half on each rank, one gathered state; (b) TP 2 (data 1 x model 2)
     at 1 + 1 images, 1 + 1 steps: the launches of one process, every split
     kernel half its output channels, the whole parameters bit-identical on
     both ranks; (c) f32, TF32 off, every candidate kept: FSDP at world 2
     (1 + 1 a rank) against one process (2 + 2) and TP 2 (1 + 1) against one
     process (1 + 1), losses 1e-4 and gradients phase 8's bound; (d) each
     split state's checkpoint restored by one process (state and momenta
     hash as gathered), one process's restored under FSDP and TP (each
     rank's parts the file's slices); then pipeline parallelism in the same
     two ranks, stage 0 and stage 1 of TPU.PP_STAGES 2: (f) the flagship at
     full width, 2 micro-batches (TPU.GRAD_ACCUM) of 2 + 2 images, 1 warm-up
     + 2 timed steps and one with its hand-off and gradient combine timed:
     per rank the step median, those ms, peak memory, launches (stage 0 the
     backbone's K4, its forwards twice: remat; stage 1 K1 2, K2 2, K3 1 and
     Res5's K4 a micro-batch; summed, one process's plus the recompute), one
     state hash, finite losses; (g) f32, TF32 off, every candidate kept: the
     pipelined step against one process at GRAD_ACCUM 2 on the same
     micro-batches (losses 1e-5, gradients phase 8's bound); (h)
     engine.runner.run under TPU.PP on phase 20's JPEG devkit: 2 steps, a
     checkpoint, an evaluation, the gathered AP against a one-process
     --eval-only of the checkpoint (1e-6); then the 2-D (data x spatial)
     mesh at (1, 2) in the same ranks, each holding half the canvas rows:
     (i) the flagship at full width, 2 + 2 images a step, 1 warm-up + 3
     steps and one with its collectives timed: per rank the step median,
     the halo exchanges' ms and calls (32 forward, 27 backward), the map's
     gather and its backward, the gradient all-reduce, peak memory,
     launches as one process's at 2 + 2 (K1 2, K2 2, K3 1, K4 124 + 103,
     the backbone's on half-height bands), one state hash; (j) f32, TF32
     off, every candidate kept: the 2-D step against (c)'s one process on
     the same 2 + 2 batch (losses 1e-5, gradients phase 8's bound); (k) the
     note (InceptionResNetV2) and the dock (VGG-CNN-F, proposals for both
     streams) recipes at full width on the same mesh, in f32 with every
     candidate kept, 1 + 2 steps of 2 + 2 images on bands of unequal height
     below their unpadded strided ops: every step's losses within 1e-5 of
     one process's, launches a rank as one process's (the note K1 2, K2 2,
     K3 1; the dock none), one state hash; step ms, the halo exchanges' ms
     and calls, the gather's ms, peak memory a rank
 23  the pairings a shipped recipe reaches with two keys changed, at full
     width and depth: (a) the note recipe with MODEL.MASK_ON and
     WSROIHeadNoMetaWithMask (the mask head over the InceptionResNetV2
     tail's 8 x 8 x 1536 map: 16 x 16 masks): 2 requests (K1 x2, K3 x2, no
     K4), K1 at the mask path's own input (P = 17 over 1088 channels, 100
     final boxes), the f32 predict with masks and the f32 train path with
     gt_masks kernels vs plain, 2 + 2 TrainerNoMeta steps of 2 + 2 images
     (K1 2, K2 2, K3 1), K2 at the step's own gradients, engine.runner.run
     on phase 12's shapes-COCO devkit (2 steps, bbox and segm AP); (b) the
     note and (c) the dock recipes with the meta architecture and
     WSROIHead: 2 + 2
     Trainer steps with the recipe's 20 x 10 support shots (the note K1 3,
     K2 2, K3 1; the dock, ROIPool and proposals for both streams, K1 1:
     its shots at P = 6 over 256 channels; both K4 in the meta Res5 over the
     shots and the query slots, forward and backward), K1 at the step's
     shots, K4 bit-identical at the meta head's shapes (P = 17 -> 9, 6 ->
     3), and meta_attention over the registered coco_note / coco_dock
     support set of phase 12's devkit; step ms, peak memory, busy share
The last three lines are the card (nvidia-smi), one JSON object describing
the kernels (launches counted on the run loop of phase 10, and per path under
launches_by_path), and {"ok": true, "device": {...}}.  Without a CUDA device, or without the
unit_tpu_torch package beside it, the script fails before any result is
printed.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "VOC" / "VOC-RCNN-101-C4-split1.yaml"
FT_RECIPE = ROOT / "configs" / "VOC" / "FT" / "10_shot" / "VOC-RCNN-101-C4-split1-ft.yaml"

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
# K2 in f32 vs its plain version, elementwise: |k - p| <= K2_REL * S, where
# S = roi_align_backward_plain(|g|) is the sum of the absolute values of the
# terms both add up (the bilinear weights are non-negative).  The two sum the
# same f32 products in different orders (K2 per feature row in ROI order, the
# plain version by index_add_), so they differ by a few f32 roundings of S;
# 2^-16 leaves a factor ~100 over 2^-23 while a missing or doubled sample
# moves a cell by one whole term.  bf16 output: one bf16 ulp beyond that.
K2_REL = 2.0 ** -16
# Train steps of phase 7, and their (canvas, content) sizes: a 600x800 image
# resized to the recipe's 800-pixel short side, in both orientations.
TRAIN_WARMUP = 2
TRAIN_STEPS = 8
TRAIN_TURN_STEPS = 4  # steps a turn of the plain epilogue against K4
TRAIN_CANVASES = (((800, 1344), (800, 1067)), ((1344, 800), (1067, 800)))
# Whole train path in f32, kernels vs plain versions: the proposals and the
# sampled slots are identical (K3 is exact); K1/K2 differ from their plain
# versions by f32 rounding (~5e-7), which the random-weight heads amplify:
# their logits are in the hundreds (loss_cls ~300), so a few leaves' gradients
# move by ~1e-3 of their own largest element (1.07e-3 on box_head res5
# block2 conv3 with --seed 0 on an H100, while the largest gradient of the
# network, G, is ~1e3 times larger).  Per leaf: max|diff| <= TRAIN_GRAD_REL * max|g_leaf|
# + TRAIN_GRAD_FLOOR * G.  A dropped or misweighted ROI sample moves the
# backbone's gradients (downstream of K2) and the losses by whole percents.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-3
TRAIN_GRAD_FLOOR = 1e-6
REMAT_LOSS_RTOL = 1e-5  # [8]: the f32 path with TPU.REMAT_BACKBONE against the key off
# The card's published peaks (NVIDIA H100 SXM data sheet), for each kernel's
# bound: the least time the card could take for the same work.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# K4 vs its plain version: bit-identical, in f32 and bf16, forward and
# backward.  The kernel does the plain version's f32 operations in its order
# with round-to-nearest intrinsics (nothing contracts into an FMA) and both
# round once to the activation's type.
K4_MAX_ABS_ERR = 0.0
# K4 shapes [N, H, W, C], (residual, relu): the stem, res2's and res4's conv3
# epilogue at one served image, a shortcut, res4 at a train step's 4 images,
# Res5 over 1024 ROIs, over a request's 100 final detections (the mask path)
# and over a fine-tune step's 4096 ROIs (backward in the COCO segm-ft step),
# the meta step's res4 over its 75 support shots at 224 and its meta head
# over the 75 shots and the 200 query slots, and two narrow ones (C = 4 and
# 130 take the scalar path).  R-50 and R-101
# share every per-layer shape; they differ in how many layers have it.
K4_SHAPES = (
    ((1, 400, 672, 64), (False, True)),
    ((1, 50, 84, 256), (True, True)),
    ((1, 50, 84, 1024), (True, True)),
    ((1, 50, 84, 1024), (False, False)),
    ((4, 50, 84, 1024), (True, True)),
    ((1024, 7, 7, 2048), (True, True)),
    ((100, 7, 7, 2048), (True, True)),
    ((4096, 7, 7, 2048), (True, True)),
    ((75, 14, 14, 1024), (True, True)),
    ((75, 7, 7, 2048), (True, True)),
    ((200, 7, 7, 2048), (True, True)),
    ((3, 5, 7, 4), (True, True)),
    ((2, 9, 11, 130), (True, True)),
)
K4_REPORTED = ((4, 50, 84, 1024), (True, True))  # the kernels line's K4 row
# Run loop (phase 10): steps, and how far the losses of a resumed run may be
# from the uninterrupted run's.  With cudnn.deterministic pinned every kernel
# of the step has a fixed summation order except PyTorch's own scatter/index
# kernels with float atomics (index_put_ with accumulate in the plain
# matcher/sampling and loss code); the script prints whether the two runs
# were bit-identical and holds them to this relative bound either way.
RUN_STEPS = 6
RUN_PERIOD = 3
RUN_TEST_IMAGES = 8
RUN_STEADY_STEPS = 14  # a longer run without hooks in the way: the loader's steady rate
RUN_EXTRA_OPTS = ()  # more config overrides (a rehearsal at a small size sets them)
DEPTH_TURNS = (0, 8, 0, 8)  # the run loop's metrics_pipeline_depth in turns (phases 10, 20)
PROFILED_STEPS = 3  # the busy share's window: a turn's last steps and train()'s drain
PEAK_REL = 0.02  # peak device memory of the depths' turns, relative
RUN_DEVICE = "cuda"  # a rehearsal of the run loop's control flow sets "cpu"
RESUME_LOSS_RTOL = 1e-3
# Folded vs unfolded evaluation.  In f32 with TF32 off the fold moves one f32
# rounding per convolution: the res4 features agree to FOLD_F32_REL of their
# largest magnitude.  In bf16 it moves one bf16 rounding per convolution (the
# weight is scaled before its cast instead of the rounded output after it),
# and a random-weight R-101 amplifies every rounding over its 100
# convolutions, so the bound is the network's own bf16 noise: the folded bf16
# features may be at most FOLD_BF16_FACTOR times as far (mean |diff|) from
# the f32 features as the unfolded bf16 features are.
FOLD_F32_REL = 1e-3
FOLD_BF16_FACTOR = 2.0
# Fine-tuning (phase 11): the recipe's batch of 8 strong images a step.
FT_IMAGES = 8
# COCO segm (phase 12): the R-50-C4 segm recipe and its fine-tune twin, with
# the mask head; served requests, timed steps, and the run loop on a
# shapes-COCO devkit (scripts/make_shapes_coco_torch.py: JPEGs and polygons).
COCO_SEGM = ROOT / "configs" / "COCO" / "COCO-RCNN-50-C4-split1-segm.yaml"
COCO_SEGM_FT = ROOT / "configs" / "COCO" / "COCO-RCNN-50-C4-split1-segm-ft.yaml"
COCO_REQUESTS = 4
COCO_TRAIN_STEPS = 6
COCO_FT_STEPS = 3
COCO_RUN_STEPS = 4
COCO_RUN_PERIOD = 2
COCO_TRAIN_IMAGES, COCO_VAL_IMAGES, COCO_IMAGE_SIZE = 8, 4, 320
# The f32 serving path with masks, kernels vs plain versions: classes and
# valid flags identical; the final boxes are decoded from deltas that differ
# by E2E_BBOX_RTOL, so they agree to 0.05 px (tests/test_torch_slice.py's
# bound); scores and mask probabilities are bounded by 1 and agree as the
# probabilities of phase 5 do.
MASK_BOX_ATOL = 0.05
MASK_PROBS_ATOL = 1e-4
# The weak detector's alternatives (phase 13): the PCL recipe's timed train
# steps, WeakRCNN's requests, TrainerOnlyWeak's and WeaklySupervisedRCNNRPN's
# timed steps, and TrainerOnlyWeakFineTune's run on phase 10's devkit.
PCL_RECIPE = ROOT / "configs" / "VOC" / "VOC-RCNN-101-C4-split1-pcl.yaml"
WEAK_TRAIN_STEPS = 6
WEAK_REQUESTS = 4
WEAK_ONLY_STEPS = 4
WEAK_RUN_STEPS = 3
# The meta recipe (phase 14): Trainer's timed steps and its run on phase 10's
# devkit.  The Gaussian likelihood of the rank losses underflows to 0 at
# D = 2048 (docs/DEVIATIONS.md), so the margin loss is exactly
# (S - 1) * 0.5 / S over S = 16 slots and the regression loss exactly 1.
META_RECIPE = ROOT / "configs" / "VOC" / "VOC-RCNN-101-C4-split1-meta.yaml"
META_TRAIN_STEPS = 6
META_RUN_STEPS = 2
META_RUN_SHOTS = 10  # the run's support shots a class (the recipe's 50: K1's [750, ...] check)
RANK_MARGIN_UNDERFLOW = 15 * 0.5 / 16
# Test-time augmentation (phase 15): TEST.AUG at its defaults on the flagship
# (scales 480-1200, MAX_SIZE 2000, flip: 10 variants in 5 groups); one image
# of the devkit's 600x800, timed TTA_TIMED times after one warm-up.
# PreciseBN's run cuts the recipe's TEST.PRECISE_BN.NUM_ITER of 200 to 4.
TTA_IMAGE = (600, 800)
TTA_TIMED = 3
TTA_EVAL_IMAGES = 2  # (c)'s --eval-only: a devkit of its own (each image ~2 s of resizes)
PRECISE_BN_ITERS = 4
PRECISE_BN_PERIOD = 3
# The note recipe (phase 16): InceptionResNetV2 cut at block17 (1088
# channels) with the InceptionResNetV2 tail as its box head over 17x17 ROIs,
# COCO's 80 classes, 300 ROIs a strong image and no FrozenBN (K4 runs nowhere
# on it).  A 480x640 image at the recipe's 600-pixel short side lies in a
# 608x1344 canvas (600x800 content); the block17 map of that canvas is 36x82
# (the stem's unpadded convolutions), not ceil(H/16) x ceil(W/16).
NOTE_RECIPE = ROOT / "configs" / "COCO" / "COCO-RCNN-50-C4-split1-note.yaml"
NOTE_REQUESTS = 4
NOTE_TRAIN_STEPS = 6
NOTE_RUN_STEPS = 4
NOTE_CANVASES = (((608, 1344), (600, 800)), ((1344, 608), (800, 600)))
NOTE_REQUEST_SHAPES = ((480, 640), (640, 480))
# The dock recipe (phase 17): VGG-CNN-F (Caffe LRN, 256 channels; an
# 800x1344 canvas gives a 49x83 map) with ROIPool at 6x6 into the VGG fc head
# (9216 -> 4096 -> 4096, dropout 0.5 in training), 80 classes, precomputed
# proposals in place of the RPN (5000 a request and a train image; 512
# sampled ROIs a strong image, the first 512 proposals of a weak one) and no
# FrozenBN; its train steps run at the YAML's largest train size, a
# 1200-pixel short side in the 1216x2016 canvas of MAX_SIZE_TRAIN 2000.
DOCK_RECIPE = ROOT / "configs" / "COCO" / "COCO-VGG-CNN-F-split1-dock.yaml"
DOCK_REQUESTS = 4
DOCK_REQUEST_SHAPES = ((480, 640), (640, 480))
DOCK_TRAIN_STEPS = 6
DOCK_YAML_STEPS = 2
DOCK_RUN_STEPS = 4


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


def cuda_ms_queued(fn, iters):
    """(device ms, host ms) per call of fn() over ``iters`` back-to-back calls.

    For kernels shorter than a launch costs the host (tens of microseconds):
    the device is first held busy by a spin kernel, so the calls queue up
    behind it and the events bracket device work only; the host's own time
    per call is read from an un-queued run.  Median of 3 such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    reps = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(host * 2.5e9))  # cycles: longer than the host needs to enqueue
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / iters)
    return float(np.median(reps)), 1e3 * host / iters


def bound(bytes_moved, flops):
    """The least time the card could take for this work, in ms: its bytes
    (each input read once, each output written once) over the HBM rate, or
    its f32 operations over the f32 peak, whichever is larger, and which."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# f32 operations per output element of ROIAlignV2 (and per gradient element
# of its backward): 4 samples x 4 corners x (multiply, add).
ROI_ALIGN_FLOPS = 32
# f32 operations of one IoU test: 4 min/max, 2 subtract, 2 clamp, 1 multiply
# (intersection); 2 add, 1 subtract (union); 1 divide, 1 compare; the areas
# are amortised.
IOU_FLOPS = 14


# --------------------------------------------------------------------------- #
def phase_env():
    import torch

    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log(f"[0] card: {card}")
    from unit_tpu_torch.ops import cuda_lib

    nvcc = run([cuda_lib.nvcc_path(), "--version"]).splitlines()[-1]
    try:
        import yaml  # noqa: F401  (unit_tpu_torch.config reads the recipes with it)
        has_yaml = f"yes ({yaml.__version__})"
    except ImportError:
        has_yaml = "no"
    try:
        import PIL  # noqa: F401  (data.transforms.load_image_bgr reads image files with it)
        has_pil = f"yes ({PIL.__version__})"
    except ImportError:
        has_pil = "no"
    log(f"[0] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc {nvcc}, PyYAML {has_yaml}, PIL {has_pil}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    from unit_tpu_torch.ops import bn_act_cuda, cuda_lib, nms_cuda, roi_align_cuda

    t0 = time.perf_counter()
    loaders = (roi_align_cuda._lib, roi_align_cuda._bwd_lib, nms_cuda._lib, bn_act_cuda._lib)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()
    log(f"[1] built the four kernels in {time.perf_counter() - t0:.1f} s (in parallel)")
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


def k1_check(feat, rois, label, tag="[2]", p=14):
    """K1 vs its plain version in f32 (the algorithm) and in bf16 (the
    working type, in ulps of the output); two launches bit-identical.
    ``p``: the pooler's output size.  Returns the bf16 max|diff|."""
    import torch

    from unit_tpu_torch.ops import roi_align as ra

    f32 = feat.float()
    got = ra.roi_align_batched(f32, rois, p, impl="cuda")
    want = ra.roi_align_batched(f32, rois, p, impl="plain")
    torch.cuda.synchronize()
    err32 = float((got - want).abs().max())
    del got, want, f32
    got16 = ra.roi_align_batched(feat, rois, p, impl="cuda")
    same = torch.equal(got16, ra.roi_align_batched(feat, rois, p, impl="cuda"))
    got16 = got16.float()
    want16 = ra.roi_align_batched(feat, rois, p, impl="plain").float()
    diff = (got16 - want16).abs()
    ulp = torch.maximum(got16.abs(), want16.abs()) * 2.0 ** -7
    ulps = float(((diff - K1_F32_ATOL).clamp_min(0.0) / ulp.clamp_min(1e-30)).max())
    err16 = float(diff.max())
    log(f"{tag} K1 {label}: f32 max|diff| {err32:.3g} (tol {K1_F32_ATOL}), bf16 max|diff| "
        f"{err16:.3g} = {ulps:.2f} ulp beyond the f32 tol (tol {K1_BF16_ULPS} ulp), two "
        f"launches bit-identical {same}")
    if not np.isfinite(err32) or err32 > K1_F32_ATOL:
        raise AssertionError(f"K1 f32 disagrees with its plain version ({label}): {err32}")
    if not np.isfinite(ulps) or ulps > K1_BF16_ULPS:
        raise AssertionError(f"K1 bf16 disagrees with its plain version ({label}): "
                             f"{ulps} ulp")
    if not same:
        raise AssertionError(f"two launches of K1 differ ({label})")
    return err16


def k1_timed(feat, rois, label, tag="[2]", p=14, plain_iters=3):
    """K1's kernel, plain and bound ms; the wrapper's host time a call."""
    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.ops.roi_align_cuda import roi_align_cuda

    k_ms = cuda_ms(lambda: roi_align_cuda(feat, rois, p), 20)
    q_ms, host_ms = cuda_ms_queued(lambda: roi_align_cuda(feat, rois, p), 20)
    p_ms = cuda_ms(lambda: ra.roi_align_batched(feat, rois, p, impl="plain"), plain_iters)
    out_elems = rois.shape[0] * rois.shape[1] * p * p * feat.shape[-1]
    least = bound(nbytes(feat, rois) + out_elems * feat.element_size(),
                  out_elems * ROI_ALIGN_FLOPS)
    log(f"{tag} K1 {label}: kernel {k_ms:.4f} ms ({q_ms:.4f} queued), plain {p_ms:.4f} ms "
        f"(median, CUDA events); wrapper host {1e3 * host_ms:.1f} us a call; bound "
        f"{least['bound_ms']:.4f} ms by {least['bound_by']}")
    return k_ms, p_ms, least


def phase_k1(rng):
    import torch

    from unit_tpu_torch.ops import roi_align as ra

    dev = torch.device("cuda")
    worst, times = 0.0, {}
    for b in (1, 2):
        feat = torch.as_tensor(rng.randn(b, 50, 84, 1024).astype(np.float32), device=dev)
        feat = feat.to(torch.bfloat16)
        rois = torch.as_tensor(np.stack([flagship_rois(rng, 1000) for _ in range(b)]), device=dev)
        worst = max(worst, k1_check(feat, rois, f"[{b},50,84,1024] x 1000 ROIs"))
        times[b] = k1_timed(feat, rois, f"B={b} x 1000 bf16")
    # the train step's shape, [2,50,84,1024] x 512, in the layouts of phase 6
    for name, make in (("piled", piled_rois), ("one band", one_band_rois)):
        rois = torch.as_tensor(np.stack([make(rng, 512) for _ in range(2)]), device=dev)
        worst = max(worst, k1_check(feat, rois, f"[2,50,84,1024] x 512 {name} ROIs"))
        k1_timed(feat, rois, f"B=2 x 512 bf16 {name} ROIs")
    # a fine-tune step's shape (phase 11): 8 images, an f32 output of 3.3 GB
    local = np.random.RandomState(80)  # leaves rng, and K3's inputs, as they were
    feat = torch.as_tensor(local.randn(8, 50, 84, 1024).astype(np.float32), device=dev)
    feat = feat.to(torch.bfloat16)
    rois = torch.as_tensor(np.stack([piled_rois(local, 512) for _ in range(8)]), device=dev)
    worst = max(worst, k1_check(feat, rois, "[8,50,84,1024] x 512 piled ROIs"))
    k1_timed(feat, rois, "B=8 x 512 bf16 piled ROIs")
    del feat
    # tiny shapes: odd sizes, H = 1 and W = 1 maps; C = 6 and 130 take the
    # channel-pair path
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
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": times[1][0], "plain_ms": times[1][1],
            **times[1][2], "library_ms": None}  # no one PyTorch call computes ROIAlignV2


def piled_rois(rng, n, h_img=800, w_img=1344):
    """ROIs as the train path lays them out: half jittered around three
    objects (sampled fg/bg slots), a quarter clipped flat against the bottom
    and right borders (invalid proposal slots), the rest uniform."""
    rois = flagship_rois(rng, n, h_img, w_img)
    objs = np.asarray([[100, 120, 400, 500], [600, 300, 900, 700], [1000, 50, 1300, 350]])
    k = n // 2
    rois[:k] = objs[rng.randint(3, size=k)] + rng.randn(k, 4) * 20
    flat = slice(k, k + n // 4)
    x1 = rng.uniform(0, w_img, n // 4)
    rois[flat] = np.stack([x1, np.full(n // 4, h_img), x1 + rng.uniform(1, 300, n // 4),
                           np.full(n // 4, h_img)], -1)
    rois[k:k + n // 8, 0] = w_img
    rois[k:k + n // 8, 2] = w_img
    return rois.astype(np.float32)


def one_band_rois(rng, n, h_img=800, w_img=1344):
    """ROIs that all lie in one 40-pixel band of the canvas: two or three
    feature rows carry every ROI, so their lists run to n entries."""
    rois = flagship_rois(rng, n, h_img, w_img)
    rois[:, 1] = h_img * 0.4 + rng.uniform(0, 10, n)
    rois[:, 3] = rois[:, 1] + rng.uniform(0, 30, n)
    return rois.astype(np.float32)


def clustered_boxes(rng, n, h=800, w=1344):
    """RPN-like boxes: clusters of overlapping boxes, some zero-area."""
    centers = rng.uniform(0, 1, (max(1, n // 20), 2)) * [w, h]
    c = centers[rng.randint(len(centers), size=n)] + rng.randn(n, 2) * 20
    wh = rng.uniform(8, 300, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    return boxes.astype(np.float32)


def nms_train_layouts(rng, images=4, n=12000, h=800, w=1344):
    """Box sets [images, n, 4] in score order at the shape of the RPN's
    training NMS (12000 -> 2000 at IoU 0.7), in three layouts:
    clustered  the boxes of clustered_boxes (most rows are kept);
    sparse     small boxes all over the canvas: nearly every row is kept, so
               the 2000 keeps are out by row ~2000 and the walk stops there;
    dense      1800 objects, each seen about seven times within a pixel: fewer
               than 2000 keeps, so every one of the n rows is walked against a
               buffer of ~1400 survivors, about the most work the shape can ask for."""
    def sparse():
        xy = rng.uniform(0, 1, (n, 2)) * [w - 40, h - 40]
        return np.concatenate([xy, xy + rng.uniform(8, 40, (n, 2))], 1)

    def dense():
        xy = rng.uniform(0, 1, (1800, 2)) * [w - 300, h - 300]
        objects = np.concatenate([xy, xy + rng.uniform(60, 300, (1800, 2))], 1)
        return objects[rng.randint(1800, size=n)] + rng.uniform(-1, 1, (n, 4))

    makers = {"clustered": lambda: clustered_boxes(rng, n, h, w), "sparse": sparse,
              "dense": dense}
    return {name: np.stack([make() for _ in range(images)]).astype(np.float32)
            for name, make in makers.items()}


def nms_rows_walked(keep, cap, n_valid=None):
    """Rows exact greedy NMS must walk, per image of these keep masks [B, N]:
    up to the cap-th keep, or every valid row where fewer are kept (the
    first ``n_valid`` of them where that is given, else all N)."""
    masks = keep.reshape(-1, keep.shape[-1])
    valid = ([masks.shape[-1]] * len(masks) if n_valid is None
             else [int(v) for v in n_valid.reshape(-1)])
    return [int(mask.nonzero()[cap - 1]) + 1 if cap is not None and int(mask.sum()) >= cap
            else n for mask, n in zip(masks, valid)]


def nms_pair_tests(keep, cap, n_valid=None):
    """IoU tests exact greedy NMS needs for these keep masks [B, N]: each row
    it walks (``nms_rows_walked``) against the boxes kept before it."""
    import torch

    total = 0
    for mask, rows in zip(keep.reshape(-1, keep.shape[-1]), nms_rows_walked(keep, cap, n_valid)):
        total += int(torch.cumsum(mask[:rows].long(), 0).sum()) - int(mask.sum())
    return total


def nms_bytes(sorted_boxes, keep, cap, n_valid=None):
    """Bytes exact greedy NMS must move for these keep masks: the box rows it
    walks (``nms_rows_walked``), ``n_valid`` where given, and the whole keep
    mask written."""
    row_bytes = sorted_boxes.shape[-1] * sorted_boxes.element_size()
    return (sum(nms_rows_walked(keep, cap, n_valid)) * row_bytes + nbytes(keep)
            + (0 if n_valid is None else nbytes(n_valid)))


def phase_k3(rng):
    import torch

    from unit_tpu_torch.ops import nms as nms_ops
    from unit_tpu_torch.ops.nms_cuda import nms_sorted_mask_cuda

    dev = torch.device("cuda")
    worst = [0.0]  # max |kernel - plain| over every keep mask compared (0 or 1)

    def same_mask(sorted_boxes, thr, cap, label, n_valid=None):
        got = nms_ops.nms_sorted_mask(sorted_boxes, thr, cap, impl="cuda", n_valid=n_valid)
        again = nms_ops.nms_sorted_mask(sorted_boxes, thr, cap, impl="cuda", n_valid=n_valid)
        want = nms_ops.nms_sorted_mask(sorted_boxes, thr, cap, impl="plain")
        n_diff = int((got != want).sum())
        worst[0] = max(worst[0], float((got.float() - want.float()).abs().max()))
        same = torch.equal(got, again)
        log(f"[3] K3 {label}: {int(got.sum())} kept, {n_diff} rows differ, two launches "
            f"bit-identical {same}")
        if n_diff or not same:
            raise AssertionError(f"K3 keep mask differs from its plain version ({label})")
        return got

    # RPN: 6000 boxes, IoU 0.7, first 1000 keeps
    boxes = torch.as_tensor(clustered_boxes(rng, 6000), device=dev)
    scores = torch.as_tensor(rng.rand(6000).astype(np.float32), device=dev)
    sb = boxes[torch.argsort(-scores, stable=True)].contiguous()
    keep = same_mask(sb, 0.7, 1000, "6000 boxes, IoU 0.7, max_keep 1000")
    same_mask(sb, 0.7, None, "6000 boxes, IoU 0.7, no cap")
    ki, kv = nms_ops.nms(boxes, scores, 0.7, 1000, impl="cuda")
    pi, pv = nms_ops.nms(boxes, scores, 0.7, 1000, impl="plain")
    if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
        raise AssertionError("K3: nms() indices differ from the plain version (RPN)")
    rpn_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.7, 1000, impl="cuda"), 20)
    rpn_plain = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.7, 1000, impl="plain"), 3)
    # The work this run's boxes need: exact greedy NMS tests each box, up to
    # the row of the last keep it returns, against the boxes kept before it.
    kept, last = int(keep.sum()), int(keep.nonzero().max())
    tests = nms_pair_tests(keep, 1000)
    rpn_bound = bound(nms_bytes(sb, keep, 1000), tests * IOU_FLOPS)
    log(f"[3] K3 RPN mask: kernel {rpn_ms:.4f} ms, plain {rpn_plain:.4f} ms; {kept} keeps, "
        f"the last at row {last}: {tests} IoU tests of a box against an earlier keep, "
        f"bound {rpn_bound['bound_ms']:.5f} ms by {rpn_bound['bound_by']} (the serial chain "
        f"of tile steps is not in this bound)")

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
    n_valid = valid.sum(dtype=torch.int32)[None]
    same_mask(sb, 0.5, 100, "20000 shifted boxes, IoU 0.5, max_keep 100")
    same_mask(sb, 0.5, 100, "20000 shifted boxes, IoU 0.5, max_keep 100, n_valid given",
              n_valid=n_valid)
    fin_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.5, 100, impl="cuda",
                                                     n_valid=n_valid), 20)
    fin_plain = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.5, 100, impl="plain"), 3)
    log(f"[3] K3 final mask: kernel {fin_ms:.4f} ms, plain {fin_plain:.4f} ms")

    # degenerate boxes (zero width/height) interleaved with duplicates; 700 is
    # not a multiple of the kernel's tile of 64; cap 1 and a cap above N
    boxes = clustered_boxes(rng, 700)
    boxes[::3, 2] = boxes[::3, 0]
    boxes[1::5, 3] = boxes[1::5, 1]
    boxes[2::7] = boxes[3::7][: len(boxes[2::7])]
    degenerate = torch.as_tensor(boxes, device=dev)
    same_mask(degenerate, 0.5, None, "700 boxes with zero-area rows")
    same_mask(degenerate, 0.5, 1, "700 boxes with zero-area rows, max_keep 1")
    same_mask(degenerate, 0.5, 705, "700 boxes with zero-area rows, max_keep 705")

    # images of different valid counts in one batch (one with none), through nms()
    b, n = 3, 1000
    boxes = torch.as_tensor(np.stack([clustered_boxes(rng, n) for _ in range(b)]), device=dev)
    scores = torch.as_tensor(rng.rand(b, n).astype(np.float32), device=dev)
    valid = torch.as_tensor(rng.rand(b, n) < np.asarray([[1.0], [0.137], [0.0]]), device=dev)
    ki, kv = nms_ops.nms(boxes, scores, 0.7, 300, valid=valid, impl="cuda")
    pi, pv = nms_ops.nms(boxes, scores, 0.7, 300, valid=valid, impl="plain")
    log(f"[3] K3 nms() over a batch of {b} x {n} boxes with {valid.sum(1).tolist()} valid: "
        f"{kv.sum(1).tolist()} kept")
    if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
        raise AssertionError("K3: batched nms() differs from the plain version (n_valid)")
    for i in range(b):
        one_i, one_v = nms_ops.nms(boxes[i], scores[i], 0.7, 300, valid=valid[i], impl="cuda")
        if not (torch.equal(one_i, ki[i]) and torch.equal(one_v, kv[i])):
            raise AssertionError("K3: an image of the batch differs from the image alone")

    # the training NMS: 4 images x 12000 boxes -> 2000 at IoU 0.7, ONE launch
    for name, batch in nms_train_layouts(rng).items():
        sb = torch.as_tensor(batch, device=dev)
        before = (nms_sorted_mask_cuda.launches, nms_sorted_mask_cuda.images)
        keep = same_mask(sb, 0.7, 2000, f"4 x 12000 {name} boxes, IoU 0.7, max_keep 2000")
        if (nms_sorted_mask_cuda.launches - before[0],
                nms_sorted_mask_cuda.images - before[1]) != (2, 8):
            raise AssertionError("K3: a batch of 4 images is not one launch a call")
        k_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.7, 2000, impl="cuda"), 20)
        p_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask(sb, 0.7, 2000, impl="plain"), 2)
        q_ms, host_ms = cuda_ms_queued(
            lambda: nms_ops.nms_sorted_mask(sb, 0.7, 2000, impl="cuda"), 20)
        tests = nms_pair_tests(keep, 2000)
        lay_bound = bound(nms_bytes(sb, keep, 2000), tests * IOU_FLOPS)
        last = [int(m.nonzero().max()) for m in keep]
        log(f"[3] K3 train shape, {name}: kernel {k_ms:.4f} ms ({q_ms:.4f} queued), plain "
            f"{p_ms:.4f} ms; {keep.sum(1).tolist()} keeps, the last at rows {last}: {tests} "
            f"IoU tests, bound {lay_bound['bound_ms']:.5f} ms by {lay_bound['bound_by']}; "
            f"wrapper host {1e3 * host_ms:.1f} us a call")
    return {"max_abs_err": worst[0], "ms": rpn_ms, "plain_ms": rpn_plain, **rpn_bound,
            "library_ms": None}  # torchvision's nms is not installed and not used


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
    frozen_bn_from_inputs(model, lambda: model.predict_raw(image, size))


def frozen_bn_from_inputs(root, fn):
    """Every FrozenBN under ``root`` takes the per-channel mean and variance
    of its own input during ``fn()`` (run without autograd), in execution
    order."""
    import torch

    from unit_tpu_torch.models.resnet import FrozenBN

    def hook(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook)
               for m in root.modules() if isinstance(m, FrozenBN)]
    try:
        with torch.no_grad():
            fn()
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


def frozen_bn_counts(model):
    """FrozenBN modules (one K4 forward launch each per pass) of the backbone
    and of one Res5 head, and how many of the backbone's sit behind a
    trainable convolution (one K4 backward launch each per step)."""
    from unit_tpu_torch.models.resnet import FrozenBN

    def walk(root):
        total = trainable = 0
        for parent in root.modules():
            for name, child in parent.named_children():
                if isinstance(child, FrozenBN):
                    total += 1
                    trainable += bool(getattr(parent, name[: -len("_bn")]).weight.requires_grad)
        return total, trainable

    backbone, backbone_trainable = walk(model.backbone)
    res5, _ = walk(model.box_head)
    return backbone, res5, backbone_trainable


def reset_launch_counts():
    from unit_tpu_torch.ops import bn_act_cuda, nms_cuda, roi_align_cuda

    for fn in (roi_align_cuda.roi_align_cuda, roi_align_cuda.roi_align_backward_cuda,
               nms_cuda.nms_sorted_mask_cuda, bn_act_cuda.bn_act_forward_cuda,
               bn_act_cuda.bn_act_backward_cuda):
        fn.launches = 0
    nms_cuda.nms_sorted_mask_cuda.images = 0
    bn_act_cuda.layout_copies = 0


def read_launch_counts():
    from unit_tpu_torch.ops import bn_act_cuda, nms_cuda, roi_align_cuda

    return {"roi_align_fwd": roi_align_cuda.roi_align_cuda.launches,
            "roi_align_bwd": roi_align_cuda.roi_align_backward_cuda.launches,
            "nms_mask": nms_cuda.nms_sorted_mask_cuda.launches,
            "nms_mask_images": nms_cuda.nms_sorted_mask_cuda.images,
            "bn_act_fwd": bn_act_cuda.bn_act_forward_cuda.launches,
            "bn_act_bwd": bn_act_cuda.bn_act_backward_cuda.launches,
            "bn_act_layout_copies": bn_act_cuda.layout_copies}


def phase_e2e(cfg, seed):
    import torch

    from unit_tpu_torch.data.transforms import prepare_test_image
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.models.similarity import VOC_CLASSES
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
    def serve_all():
        lat, results = [], []
        for img in images:
            t0 = time.perf_counter()
            results.append(svc.detect_array(img))  # ends in a device-to-host copy
            lat.append((time.perf_counter() - t0) * 1e3)
        return lat, results

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, results = serve_all()
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[4] {REQUESTS} requests, latency ms {[round(v, 2) for v in lat]}, "
        f"median {np.median(lat):.2f}, peak device memory {peak / 2**20:.1f} MiB")
    n_backbone, n_res5, _ = frozen_bn_counts(model)
    k4_per_request = n_backbone + (2 if mc.multi_box_head else 1) * n_res5
    log(f"[4] launches during the requests: {launches}; FrozenBN modules: backbone "
        f"{n_backbone}, one Res5 head {n_res5} -> {k4_per_request} K4 launches a request")
    want = {"roi_align_fwd": REQUESTS, "roi_align_bwd": 0, "nms_mask": 2 * REQUESTS,
            "nms_mask_images": 2 * REQUESTS,  # the RPN's and the final NMS, one image each
            "bn_act_fwd": k4_per_request * REQUESTS, "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    if launches != want:
        raise AssertionError(f"the path did not run K1 x1, K3 x2 and K4 x{k4_per_request} "
                             f"per request without layout copies: {launches}")
    # the same requests with the plain epilogue and with K4, in turns
    medians = {"cuda": [float(np.median(lat))], "plain": []}
    for impl in ("plain", "cuda", "plain"):
        set_bn_act_impl(model, impl)
        svc.warmup()
        medians[impl].append(float(np.median(serve_all()[0])))
    set_bn_act_impl(model, "cuda")
    log(f"[4] request medians ms, bn_act_impl in turns: cuda {medians['cuda']}, plain "
        f"{medians['plain']}")
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
    profile_run(lambda: svc.detect_array(image), "[4]", "request")


def device_rows(prof):
    """(device ms, count, name) of a finished torch.profiler's device-side
    events only (kernels, copies): the CPU-side aten ops carry the same
    device time again, and so do annotated ranges such as
    Optimizer.step#SGD.step."""
    return [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def loop_recording(made):
    """A TrainerNoMeta class for the run loop's turns (phases 10 and 20)
    whose trainers keep themselves in ``made``.  Its class attributes set a
    turn: ``depth``, the trainer's metrics_pipeline_depth (the deferred loss
    fetch), and ``profile_last`` = n, the last n steps and train()'s drain
    under torch.profiler.  A trainer keeps the host clock at each step's
    start (``starts``) and after train()'s drain (``end``), so
    ``window_ms(k)`` is the wall time of the steps from k on a step, in a
    window that ends in a drain; ``launches``, each step's kernel launches
    (the counters' growth: their totals stay the run's); ``busy``, the
    device's busy ms and share of the profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unit_tpu_torch.engine.train import TrainerNoMeta

    class Recording(TrainerNoMeta):
        depth, profile_last = 8, 0

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.metrics_pipeline_depth = type(self).depth
            self.starts, self.launches, self.end, self.busy = [], [], None, None
            self._profile_from = self._prof = None
            made.append(self)

        def run_step(self):
            if self.state.step == self._profile_from:  # the device's events alone: cheap
                self._prof = profile(activities=[ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [ProfilerActivity.CPU])
                self._prof.start()
            self.starts.append(time.perf_counter())
            before = read_launch_counts()
            metrics = super().run_step()
            self.launches.append({k: v - before[k] for k, v in read_launch_counts().items()})
            return metrics

        def train(self, max_iter, hooks=()):
            self._profile_from = max_iter - self.profile_last if self.profile_last else None
            try:
                return super().train(max_iter, hooks)
            finally:  # super().train() drained the losses in flight
                self.end = time.perf_counter()
                if self._prof is not None:
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                    self._prof.stop()
                    wall = (self.end - self.starts[-self.profile_last]) * 1e3
                    busy = sum(r[0] for r in device_rows(self._prof))
                    self.busy, self._prof = (busy, busy / wall), None

        def window_ms(self, first):
            return (self.end - self.starts[first]) * 1e3 / (len(self.starts) - first)

    return Recording


@contextlib.contextmanager
def no_final_evaluation(runner):
    """A run-loop turn times steps: ``runner.run``'s final evaluation (the
    devkit's test images, which no turn reads) is left out while the context
    lasts, and ``run`` returns empty results."""
    real = runner.make_eval_fn
    runner.make_eval_fn = lambda *a, **kw: (lambda state: {})
    try:
        yield
    finally:
        runner.make_eval_fn = real


def profile_run(fn, tag, what, top=15):
    """torch.profiler over one fn() that ends in a device-to-host copy:
    wall time, device busy share and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unit_tpu_torch.utils.profiling import kernel_kind

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    log(f"{tag} profiled {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%), "
        f"{n_ops} device ops")
    by_kind = {}
    for ms, count, key in rows:
        kind = kernel_kind(key)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    log(f"{tag} device ms by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"{tag}   {ms:9.3f} ms  x{count:<5d} {key[:110]}")
    torch.cuda.synchronize()
    return {"wall_ms": wall, "busy_ms": busy, "device_ops": n_ops}


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
    predict_path_kernels_vs_plain(model, img, size, "[5]")


def predict_path_kernels_vs_plain(model, img, size, tag):
    """predict_raw with the kernels (K1, K3, K4) and with their plain
    versions: identical proposals, probabilities within E2E_PROBS_ATOL and
    box deltas within E2E_BBOX_RTOL of their largest magnitude."""
    import torch

    from unit_tpu_torch.models.resnet import set_bn_act_impl

    outs, mc = {}, model.mc
    try:
        for impl in ("cuda", "plain"):
            model.mc = dataclasses.replace(mc, roi_align_impl=impl, nms_impl=impl)
            set_bn_act_impl(model, impl)
            with torch.inference_mode():
                probs, bbox, props, _ = model.predict_raw(img, size)
            outs[impl] = (probs, bbox, props)
    finally:
        model.mc = mc
        set_bn_act_impl(model, mc.bn_act_impl)
    (pk, bk, prk), (pp, bp, prp) = outs["cuda"], outs["plain"]
    same_props = torch.equal(prk.valid, prp.valid) and torch.equal(prk.boxes, prp.boxes)
    dprobs = float((pk - pp).abs().max())
    dbbox = float((bk - bp).abs().max()) / max(1.0, float(bp.abs().max()))
    log(f"{tag} proposals identical: {same_props} ({int(prk.valid.sum())} valid); probs "
        f"max|diff| {dprobs:.3g} (tol {E2E_PROBS_ATOL}); bbox max|diff|/max|bbox| "
        f"{dbbox:.3g} (tol {E2E_BBOX_RTOL})")
    if not (same_props and dprobs <= E2E_PROBS_ATOL and dbbox <= E2E_BBOX_RTOL):
        raise AssertionError("the whole path with kernels disagrees with the plain path")

def k2_check(g, rois, shape, p, label, tag="[6]"):
    """K2 vs its plain version, elementwise within K2_REL of the summed
    absolute terms (+ one bf16 ulp for a bf16 g); two launches
    bit-identical.  Returns the max|diff|."""
    import torch

    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.ops.roi_align_cuda import roi_align_backward_cuda

    got = roi_align_backward_cuda(g, rois, shape, p)
    again = roi_align_backward_cuda(g, rois, shape, p)
    want = ra.roi_align_backward_plain(g, rois, shape, p)
    s_abs = ra.roi_align_backward_plain(g.float().abs(), rois, shape, p)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    bound = s_abs * K2_REL
    if g.dtype == torch.bfloat16:
        bound = bound + torch.maximum(got.float().abs(), want.float().abs()) * 2.0 ** -7
    rel = float((diff / s_abs.clamp_min(1e-30)).max())
    same = torch.equal(got, again)
    log(f"{tag} K2 {label}: max|diff| {float(diff.max()):.3g}, max|diff|/S {rel:.3g} "
        f"(bound {K2_REL:.3g}{' + 1 bf16 ulp' if g.dtype == torch.bfloat16 else ''}), "
        f"two launches bit-identical {same}")
    if not (bool((diff <= bound).all()) and same):
        raise AssertionError(f"K2 disagrees with its plain version ({label})")
    return float(diff.max())


def k2_timed(g, rois, shape, label, tag="[6]", p=14):
    """K2's kernel (and queued) and plain ms; the wrapper's host time and its
    scratch.  Returns (kernel ms, plain ms, queued ms)."""
    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.ops.roi_align_cuda import roi_align_backward_cuda

    k_ms = cuda_ms(lambda: roi_align_backward_cuda(g, rois, shape, p), 10)
    p_ms = cuda_ms(lambda: ra.roi_align_backward_plain(g, rois, shape, p), 3)
    q_ms, host_ms = cuda_ms_queued(lambda: roi_align_backward_cuda(g, rois, shape, p), 10)
    sizes = roi_align_backward_cuda.scratch_bytes
    log(f"{tag} K2 {label}: kernel {k_ms:.4f} ms ({q_ms:.4f} queued), plain {p_ms:.4f} ms "
        f"(median, CUDA events); wrapper host {1e3 * host_ms:.1f} us a call; scratch "
        f"{sizes['scratch'] / 1e6:.1f} MB allocated + workspace "
        f"{sizes['workspace'] / 1e6:.2f} MB")
    return k_ms, p_ms, q_ms


def phase_k2(rng):
    import torch

    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.ops.roi_align_cuda import BWD_TUNING

    dev = torch.device("cuda")

    worst, times = 0.0, {}
    for b in (1, 2):
        shape = (b, 50, 84, 1024)
        rois = torch.as_tensor(np.stack([flagship_rois(rng, 512) for _ in range(b)]), device=dev)
        g32 = torch.as_tensor(rng.randn(b, 512, 14, 14, 1024).astype(np.float32), device=dev)
        k2_check(g32, rois, shape, 14, f"[{b},512,14,14,1024] f32")
        g16 = g32.to(torch.bfloat16)
        if b == 2:
            # the train path's layout (ROIs piled onto a few rows), and rows whose
            # lists are longer than two of the kernel's segments
            piled = torch.as_tensor(np.stack([piled_rois(rng, 512) for _ in range(b)]),
                                    device=dev)
            long_rows = torch.as_tensor(np.stack([one_band_rois(rng, 512) for _ in range(b)]),
                                        device=dev)
            longest = int(ra.roi_row_lists(long_rows, 50, 84)[1].max())
            seg = BWD_TUNING["seg"]
            log(f"[6] K2 one-band ROIs: the longest row list has {longest} entries "
                f"({-(-longest // seg)} segments of at most {seg})")
            if longest <= 2 * seg:
                raise AssertionError("the one-band ROIs do not fill more than two segments")
            k2_check(g32, piled, shape, 14, "[2,512,14,14,1024] f32 piled")
            k2_check(g32, long_rows, shape, 14, "[2,512,14,14,1024] f32 one band")
        del g32
        worst = max(worst, k2_check(g16, rois, shape, 14, f"[{b},512,14,14,1024] bf16"))
        k_ms, p_ms, _ = k2_timed(g16, rois, shape, f"B={b} bf16")
        out_bytes = int(np.prod(shape)) * g16.element_size()
        times[b] = (k_ms, p_ms, bound(nbytes(g16, rois) + out_bytes,
                                      g16.numel() * ROI_ALIGN_FLOPS))
        log(f"[6] K2 B={b} bf16: bound {times[b][2]['bound_ms']:.4f} ms by "
            f"{times[b][2]['bound_by']}")
        if b == 2:
            worst = max(worst, k2_check(g16, piled, shape, 14, "[2,512,14,14,1024] bf16 piled"))
            k2_timed(g16, piled, shape, "B=2 bf16 piled ROIs")
            worst = max(worst, k2_check(g16, long_rows, shape, 14,
                                     "[2,512,14,14,1024] bf16 one band"))
            k2_timed(g16, long_rows, shape, "B=2 bf16 one-band ROIs")
    # tiny shapes: odd sizes, H = 1 and W = 1 maps
    for shape in ((1, 1, 5, 8), (2, 7, 1, 6), (1, 9, 11, 130)):
        rois = torch.as_tensor(
            np.stack([flagship_rois(rng, 17, shape[1] * 16, shape[2] * 16)
                      for _ in range(shape[0])]), device=dev)
        g = torch.as_tensor(rng.randn(shape[0], 17, 7, 7, shape[3]).astype(np.float32),
                            device=dev)
        k2_check(g, rois, shape, 7, f"{shape} x 17 ROIs P=7 f32")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": times[2][0], "plain_ms": times[2][1],
            **times[2][2], "library_ms": None}  # no one PyTorch call computes its backward


def synthetic_train_batches(cfg, seed, n_batches=4, per_stream=2, max_gt=5,
                            canvases=None):
    """Strong and weak numpy batches made from ``seed``, their canvases
    alternating between the two (canvas, content) sizes of ``canvases``
    (TRAIN_CANVASES by default; strong and weak of one step share the canvas).

    Random BGR content fills the content size, zero padding the rest; strong
    images carry 1..max_gt base-class boxes (padded to TPU.MAX_GT_BOXES),
    weak images a multi-hot label over all classes.  Under MODEL.MASK_ON
    the strong images also carry each box's 28 x 28 mask in its frame (an
    ellipse), drawn after everything else."""
    rng = np.random.RandomState(seed + 7)
    base = np.asarray(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
    n_cls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    g_cap = cfg.TPU.MAX_GT_BOXES
    strong, weak = [], []
    canvases = canvases or TRAIN_CANVASES
    for k in range(n_batches):
        canvas, content = canvases[k % 2]

        def images():
            im = np.zeros((per_stream,) + canvas + (3,), np.float32)
            im[:, :content[0], :content[1]] = rng.uniform(
                0, 255, (per_stream,) + content + (3,)).astype(np.float32)
            return im

        sizes = np.asarray([content] * per_stream, np.float32)
        boxes = np.zeros((per_stream, g_cap, 4), np.float32)
        classes = np.zeros((per_stream, g_cap), np.int32)
        valid = np.zeros((per_stream, g_cap), bool)
        for i in range(per_stream):
            n = rng.randint(1, max_gt + 1)
            wh = rng.uniform(0.06, 0.5, (n, 2)) * np.asarray(content[::-1])
            xy = rng.uniform(0, 1, (n, 2)) * (np.asarray(content[::-1]) - wh)
            boxes[i, :n] = np.concatenate([xy, xy + wh], 1)
            classes[i, :n] = rng.choice(base, n)
            valid[i, :n] = True
        labels = np.zeros((per_stream, n_cls), np.float32)
        for i in range(per_stream):
            labels[i, rng.choice(n_cls, rng.randint(1, 4), replace=False)] = 1.0
        strong.append(dict(image=images(), gt_boxes=boxes, gt_classes=classes,
                           gt_valid=valid, image_size=sizes))
        weak.append(dict(image=images(), labels=labels, image_size=sizes))
    if cfg.MODEL.MASK_ON:
        yy, xx = (np.mgrid[:28, :28] + 0.5) / 28.0
        for batch in strong:
            c = rng.uniform(0.35, 0.65, (2, per_stream, g_cap, 1, 1))
            r = rng.uniform(0.25, 0.5, (2, per_stream, g_cap, 1, 1))
            inside = ((yy - c[0]) / r[0]) ** 2 + ((xx - c[1]) / r[1]) ** 2 < 1
            batch["gt_masks"] = (inside & batch["gt_valid"][..., None, None]).astype(np.float32)
    return strong, weak


def phase_train(cfg, seed):
    import torch

    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # The recipe starts from ImageNet weights; from random weights its SGD
    # diverges within ~10 steps of the LR ramp (losses ~1e15, then NaN), so
    # the smoke clips the gradient by its global norm (SOLVER.CLIP_GRADIENTS,
    # off in the recipe).
    cfg = cfg.clone()
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    model = flagship_model(cfg, seed, dev)
    solver = build_optimizer(cfg, model)
    mc = model.mc
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    strong, weak = synthetic_train_batches(cfg, seed)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    log(f"[7] R-{mc.depth}-C4 train set-up in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in start.values()) / 1e6:.1f} M trainable params in "
        f"{len(start)} tensors, {len(frozen)} frozen (FREEZE_AT "
        f"{cfg.MODEL.BACKBONE.FREEZE_AT}), {len(solver.optimizer.param_groups)} SGD groups, "
        f"gradient clipped to global norm {cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE}, "
        f"compute {mc.compute_dtype}, RPN train {mc.rpn.pre_nms_topk_train}->"
        f"{mc.rpn.post_nms_topk_train}, {mc.roi_batch_size} ROIs per strong image, "
        f"{mc.weak_proposal_count} per weak image")

    # which trainable tensors got a non-zero gradient in some step (on the
    # device; read once at the end)
    params = dict(model.named_parameters())
    had_grad = {n: torch.zeros((), dtype=torch.bool, device=dev) for n in start}

    def step(label):
        lr = solver.optimizer.param_groups[0]["lr"]
        t = time.perf_counter()
        m = trainer.run_step().resolve()  # read now: the clock holds the device's time
        ms = (time.perf_counter() - t) * 1e3
        for n, flag in had_grad.items():
            if params[n].grad is not None:
                flag |= params[n].grad.ne(0).any()
        log(f"[7] step {trainer.state.step} ({label}) {ms:.1f} ms, lr {lr:.6g}: "
            + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
        return ms

    for _ in range(TRAIN_WARMUP):
        step("warm-up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = [step("timed") for _ in range(TRAIN_STEPS)]
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(times))
    imgs = 2 * strong[0]["image"].shape[0]
    log(f"[7] {TRAIN_STEPS} timed steps: median {med:.2f} ms (min {min(times):.2f}, max "
        f"{max(times):.2f}), {1e3 * imgs / med:.2f} images/s ({imgs} per step), peak "
        f"device memory {peak / 2**20:.1f} MiB")
    log(f"[7] launches during the timed steps: {launches}")
    # K4: one forward launch per FrozenBN of the fused backbone pass and of
    # the three Res5 passes; one backward launch per FrozenBN that autograd
    # differentiates (behind a trainable convolution: res3, res4 and the two
    # Res5 passes with gradient)
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)
    k4_fwd, k4_bwd = n_backbone + 3 * n_res5, n_trainable + 2 * n_res5
    log(f"[7] FrozenBN modules: backbone {n_backbone} ({n_trainable} behind a trainable "
        f"convolution), one Res5 head {n_res5} -> {k4_fwd} K4 forward and {k4_bwd} K4 "
        f"backward launches a step")
    want = {"roi_align_fwd": 2 * TRAIN_STEPS, "roi_align_bwd": 2 * TRAIN_STEPS,
            # one launch of K3 for the step's 2 strong + 2 weak images
            "nms_mask": TRAIN_STEPS, "nms_mask_images": 4 * TRAIN_STEPS,
            "bn_act_fwd": k4_fwd * TRAIN_STEPS,
            "bn_act_bwd": k4_bwd * TRAIN_STEPS,
            # the spatial mean after each Res5 pass with gradient hands its last
            # epilogue an NCHW-contiguous gradient: one counted conversion each
            "bn_act_layout_copies": 2 * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"the train path did not run K1 x2, K2 x2, K3 x1 (4 images), K4 x{k4_fwd} "
                             f"forward and x{k4_bwd} backward per step with 2 layout "
                             f"copies: {launches}")
    # the same steps with the plain epilogue and with K4, in turns
    medians = {"cuda": [med], "plain": []}
    for impl in ("plain", "cuda", "plain"):
        set_bn_act_impl(model, impl)
        step(f"warm-up, bn_act {impl}")
        medians[impl].append(float(np.median([step(f"bn_act {impl}")
                                              for _ in range(TRAIN_TURN_STEPS)])))
    set_bn_act_impl(model, "cuda")
    log(f"[7] step medians ms, bn_act_impl in turns: cuda {medians['cuda']}, plain "
        f"{medians['plain']}")
    # TPU.REMAT_BACKBONE in turns with the key off: the step, the peak, and
    # the launches (the backbone's K4 forwards run again in backward)
    remat = {True: [], False: []}
    for on in (True, False, True, False):
        model.mc = dataclasses.replace(model.mc, remat_backbone=on)
        step(f"warm-up, remat {on}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        turn = float(np.median([step(f"remat {on}") for _ in range(TRAIN_TURN_STEPS)]))
        remat[on].append((turn, torch.cuda.max_memory_allocated()))
        got = read_launch_counts()
        want_turn = {k: v // TRAIN_STEPS * TRAIN_TURN_STEPS for k, v in want.items()}
        want_turn["bn_act_fwd"] += on * n_backbone * TRAIN_TURN_STEPS
        if got != want_turn:
            raise AssertionError(f"the train path with TPU.REMAT_BACKBONE {on} did not launch "
                                 f"{want_turn} in {TRAIN_TURN_STEPS} steps: {got}")
    model.mc = dataclasses.replace(model.mc, remat_backbone=False)
    log(f"[7] TPU.REMAT_BACKBONE in turns (on, off, on, off; each {TRAIN_TURN_STEPS} steps "
        f"after a warm-up): step medians ms on {[round(t, 2) for t, _ in remat[True]]}, off "
        f"{[round(t, 2) for t, _ in remat[False]]}; peak device memory MiB on "
        f"{[round(m / 2**20, 1) for _, m in remat[True]]}, off "
        f"{[round(m / 2**20, 1) for _, m in remat[False]]}; launches a step with the key on "
        f"K4 {k4_fwd + n_backbone} + {k4_bwd} (the backbone's {n_backbone} forwards again), "
        f"K1 2, K2 2, K3 1, as gated")
    for metrics in trainer.metrics_history:
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite loss: {metrics}")
    zero_grad = [n for n, flag in had_grad.items() if not bool(flag)]
    still = [n for n, p in start.items() if torch.equal(p, params[n])]
    unmoved = [n for n in still if n not in zero_grad]
    changed = [n for n, p in frozen.items() if not torch.equal(p, params[n])]
    log(f"[7] trainable tensors moved: {len(start) - len(still)}/{len(start)}; with an "
        f"all-zero gradient in every step: {zero_grad}; frozen tensors bit-unchanged: "
        f"{len(frozen) - len(changed)}/{len(frozen)}")
    if unmoved or changed:
        raise AssertionError(f"trainable tensors with a gradient that did not move {unmoved[:5]}, "
                             f"changed frozen {changed[:5]}")
    profile_run(trainer.run_step, "[7]", "train step", top=20)
    del trainer, model, solver
    torch.cuda.empty_cache()
    return launches


def train_path_kernels_vs_plain(model, strong, weak, seed, tag, meta=None):
    """train_losses + backward with the kernels and with their plain versions
    (same weights, same generator seed, the support batch ``meta`` of a meta
    model): the proposals and sampled slots must be identical, the losses
    within TRAIN_LOSS_RTOL and every gradient within TRAIN_GRAD_REL of its
    leaf's largest element + TRAIN_GRAD_FLOOR of the network's; a meta
    model's margin and regression rank losses are exactly the underflow's
    constants.  Returns the launch counts of the kernels' pass."""
    import torch

    from unit_tpu_torch.models import rpn as rpn_lib
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.ops import sampling as sampling_ops

    # record the proposals and sampled slots train_losses draws
    recorded = []
    real_select, real_sample = rpn_lib.select_proposals, sampling_ops.label_and_sample_proposals

    def select(*a, **kw):
        out = real_select(*a, **kw)
        recorded.append(("proposals", out.boxes, out.valid))
        return out

    def sample(*a, **kw):
        out = real_sample(*a, **kw)
        recorded.append(("sampled", out.boxes, out.gt_classes, out.valid))
        return out

    runs = {}
    rpn_lib.select_proposals, sampling_ops.label_and_sample_proposals = select, sample
    try:
        for impl in ("cuda", "plain"):
            model.mc = dataclasses.replace(model.mc, roi_align_impl=impl, nms_impl=impl)
            set_bn_act_impl(model, impl)
            model.zero_grad(set_to_none=True)
            recorded.clear()
            reset_launch_counts()
            gen = torch.Generator(device=strong["image"].device)
            gen.manual_seed(seed)
            losses = model.train_losses(gen, strong, weak, meta=meta)
            torch.stack(list(losses.values())).sum().backward()
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None}
            runs[impl] = ({k: float(v.detach()) for k, v in losses.items()}, list(recorded),
                          grads, read_launch_counts())
    finally:
        rpn_lib.select_proposals = real_select
        sampling_ops.label_and_sample_proposals = real_sample
        set_bn_act_impl(model, "cuda")
    (lk, rk, gk, launches), (lp, rp, gp, _) = runs["cuda"], runs["plain"]
    same = len(rk) == len(rp) and all(
        a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
        for a, b in zip(rk, rp))
    loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    scale = {n: float(g.abs().max()) for n, g in gp.items()}
    big = max(scale.values())
    diffs = {n: float((gk[n] - gp[n]).abs().max()) for n in gp if n in gk}
    over = {n: d / (TRAIN_GRAD_REL * scale[n] + TRAIN_GRAD_FLOOR * big)
            for n, d in diffs.items()}
    log(f"{tag} f32, TF32 off: proposals and sampled slots identical {same} ({len(rk)} "
        f"records); losses max rel diff {loss_rel:.3g} (tol {TRAIN_LOSS_RTOL}); "
        f"{len(gp)} gradients, largest |grad| G = {big:.4g}, worst max|diff|/bound "
        f"{max(over.values()):.3g} (bound {TRAIN_GRAD_REL} * max|g_leaf| + "
        f"{TRAIN_GRAD_FLOOR} * G)")
    for n in sorted(over, key=over.get, reverse=True)[:5]:
        log(f"{tag}   {n}: max|diff| {diffs[n]:.3g}, max|g| {scale[n]:.3g}, "
            f"diff/bound {over[n]:.3g}")
    log(f"{tag} losses (kernels): " + ", ".join(f"{k} {v:.6g}" for k, v in lk.items()))
    if not (same and set(gk) == set(gp) and loss_rel <= TRAIN_LOSS_RTOL
            and max(over.values()) <= 1.0):
        raise AssertionError("the train path with kernels disagrees with the plain path")
    if "gt_masks" in strong and not np.isfinite(lk.get("loss_mask", np.nan)):
        raise AssertionError(f"the train path with masks has no finite loss_mask: {lk}")
    if meta is not None:
        for impl, losses in (("kernels", lk), ("plain", lp)):
            if not (losses["loss_rank_margin"] == RANK_MARGIN_UNDERFLOW
                    and losses["loss_rank_reg"] == 1.0 and losses["loss_rank_cls"] > 0):
                raise AssertionError(f"the rank losses ({impl}) are not the likelihood "
                                     f"underflow's constants: {losses}")
    return launches


def phase_train_whole_path(cfg, seed):
    import torch

    from unit_tpu_torch.solver import build_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    dev = torch.device("cuda")
    model = flagship_model(cfg32, seed, dev)
    build_optimizer(cfg32, model)  # freezes the stem and res2
    strong, weak = synthetic_train_batches(cfg32, seed + 1, n_batches=1)
    strong = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    weak = {k: torch.as_tensor(v, device=dev) for k, v in weak[0].items()}
    train_path_kernels_vs_plain(model, strong, weak, seed, "[8]")
    remat_against_off(model, strong, weak, seed, "[8]")
    del model
    torch.cuda.empty_cache()


def remat_against_off(model, strong, weak, seed, tag):
    """train_losses + backward with the kernels and TPU.REMAT_BACKBONE on
    against off (same weights and generator seed): the losses within
    REMAT_LOSS_RTOL, every gradient within phase 8's bound (and how many are
    bit-identical), and the launches: the backbone's K4 forwards once more."""
    import torch

    runs = {}
    for on in (False, True):
        model.mc = dataclasses.replace(model.mc, roi_align_impl="cuda", nms_impl="cuda",
                                       remat_backbone=on)
        model.zero_grad(set_to_none=True)
        reset_launch_counts()
        gen = torch.Generator(device=strong["image"].device)
        gen.manual_seed(seed)
        losses = model.train_losses(gen, strong, weak)
        torch.stack(list(losses.values())).sum().backward()
        runs[on] = ({k: float(v.detach()) for k, v in losses.items()},
                    {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None}, read_launch_counts())
    model.mc = dataclasses.replace(model.mc, remat_backbone=False)
    model.zero_grad(set_to_none=True)
    (l0, g0, c0), (l1, g1, c1) = runs[False], runs[True]
    loss_rel = max(abs(l1[k] - l0[k]) / max(abs(l0[k]), 1e-12) for k in l0)
    big = max(float(g.abs().max()) for g in g0.values())
    over = {n: float((g1[n] - g0[n]).abs().max()) / (TRAIN_GRAD_REL * float(g0[n].abs().max())
                                                      + TRAIN_GRAD_FLOOR * big) for n in g0}
    equal = sum(torch.equal(g1[n], g0[n]) for n in g0)
    n_backbone = frozen_bn_counts(model)[0]
    want = dict(c0, bn_act_fwd=c0["bn_act_fwd"] + n_backbone)
    log(f"{tag} f32, TPU.REMAT_BACKBONE on against off: losses max rel diff {loss_rel:.3g} "
        f"(tol {REMAT_LOSS_RTOL}), identical {l1 == l0}; {len(g0)} gradients, "
        f"{equal} bit-identical, worst max|diff|/bound {max(over.values()):.3g}; launches on "
        f"{c1} (off {c0})")
    if set(g1) != set(g0) or loss_rel > REMAT_LOSS_RTOL or max(over.values()) > 1.0:
        raise AssertionError("the train path with TPU.REMAT_BACKBONE disagrees with the key off")
    if c1 != want:
        raise AssertionError(f"TPU.REMAT_BACKBONE did not launch {want}: {c1}")


def k4_case(rng, shape, has_res, relu, tag="[9]"):
    """K4 at one NHWC ``shape`` against its plain version, forward and
    backward, f32 and bf16 (bit-identical, two backward launches
    bit-identical, NHWC-dense outputs), then timed in bf16 beside the plain
    version, the four-op chain it replaces and the bound of the bytes it must
    move.  Returns the largest difference and the times."""
    import torch

    from unit_tpu_torch.ops import bn_act as ba
    from unit_tpu_torch.ops import bn_act_cuda as k4

    dev = torch.device("cuda")

    def chain(x, s16, t16, res, relu):
        """The four-op chain the model ran before the fused epilogue: scale
        and shift rounded to the activation's type, one pass per operation."""
        y = x * s16 + t16
        if res is not None:
            y = y + res
        return torch.relu(y) if relu else y

    n, h, w, c = shape
    worst = 0.0
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, c).astype(np.float32), device=dev)
    shift = torch.as_tensor((rng.randn(c) * 0.3).astype(np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(2 ** 31)))
    label = f"[{n},{h},{w},{c}] res={int(has_res)} relu={int(relu)}"
    for dtype in (torch.float32, torch.bfloat16):
        def nhwc():
            return torch.randn(shape, generator=gen, device=dev).to(dtype).permute(0, 3, 1, 2)

        x, res, g = nhwc(), (nhwc() if has_res else None), nhwc()
        outs = {}
        for impl in ("cuda", "plain"):
            xi = x.clone().requires_grad_(True)
            ri = res.clone().requires_grad_(True) if has_res else None
            y = ba.bn_act(xi, scale, shift, ri, relu, impl)
            y.backward(g)
            outs[impl] = [y.detach(), xi.grad] + ([ri.grad] if has_res else [])
            del xi, ri, y
        again = k4.bn_act_backward_cuda(g, outs["cuda"][0] if relu else None, scale, relu,
                                        need_dx=True, need_dres=has_res)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(outs["cuda"], outs["plain"]))
        same = all(torch.equal(a, b) for a, b in zip(outs["cuda"], outs["plain"]))
        twice = all(torch.equal(a, b) for a, b in zip(outs["cuda"][1:], again))
        dense = all(k4.nhwc_dense(t) for t in outs["cuda"])
        log(f"{tag} K4 {label} {str(dtype).split('.')[-1]}: forward and backward "
            f"max|diff| {err:.3g} (tol {K4_MAX_ABS_ERR}), bit-identical {same}, two "
            f"backward launches bit-identical {twice}, outputs NHWC-dense {dense}")
        if not (err <= K4_MAX_ABS_ERR and same and twice and dense):
            raise AssertionError(f"K4 disagrees with its plain version ({label} {dtype})")
        worst = max(worst, err)
        y_saved = outs["cuda"][0]
        del outs, again
    # times in bf16 (x, res, g, y_saved are the bf16 tensors of the last pass)
    s16 = scale.to(torch.bfloat16).view(1, -1, 1, 1)
    t16 = shift.to(torch.bfloat16).view(1, -1, 1, 1)
    with torch.no_grad():
        k_ms, k_host = cuda_ms_queued(
            lambda: k4.bn_act_forward_cuda(x, scale, shift, res, relu), 20)
        p_ms, _ = cuda_ms_queued(lambda: ba.bn_act_plain(x, scale, shift, res, relu), 10)
        c_ms, c_host = cuda_ms_queued(lambda: chain(x, s16, t16, res, relu), 10)
        kb_ms, _ = cuda_ms_queued(lambda: k4.bn_act_backward_cuda(
            g, y_saved if relu else None, scale, relu, True, has_res), 20)
        pb_ms, _ = cuda_ms_queued(
            lambda: ba.bn_act_backward_plain(g, y_saved, scale, relu), 10)
    elems = x.numel()
    # forward: x [+ res] read, out written; backward: g [+ y] read, dx [+ dres] written;
    # 3 or 4 f32 operations an element
    fwd = bound((2 + has_res) * elems * 2 + 8 * c, (3 + has_res) * elems)
    bwd = bound((2 + relu + (has_res and relu)) * elems * 2 + 4 * c, 2 * elems)
    log(f"{tag} K4 {label} bf16 forward: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"four-op chain {c_ms:.4f} ms, bound {fwd['bound_ms']:.4f} ms by {fwd['bound_by']} "
        f"({100 * fwd['bound_ms'] / k_ms:.0f}% of the kernel's time); backward: kernel "
        f"{kb_ms:.4f} ms, plain {pb_ms:.4f} ms, bound {bwd['bound_ms']:.4f} ms; host time "
        f"to enqueue one call: kernel wrapper {k_host:.4f} ms, chain {c_host:.4f} ms")
    del x, res, g, y_saved
    torch.cuda.empty_cache()
    # no one PyTorch call computes the epilogue (library_ms null); the chain is four calls
    return {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, **fwd, "library_ms": None,
            "chain_ms": c_ms, "host_ms": k_host, "bwd_ms": kb_ms, "bwd_plain_ms": pb_ms,
            "bwd_bound_ms": bwd["bound_ms"]}


def phase_k4(rng):
    worst, reported = 0.0, None
    for shape, (has_res, relu) in K4_SHAPES:
        row = k4_case(rng, shape, has_res, relu)
        worst = max(worst, row["max_abs_err"])
        if (shape, (has_res, relu)) == K4_REPORTED:
            reported = row
    return {**reported, "max_abs_err": worst}


_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objects}
</annotation>"""
_OBJ = """<object><name>{name}</name><difficult>0</difficult>
  <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
</object>"""


def natural_image(rng, h, w):
    """uint8 RGB [h, w, 3] with a photo's smoothness (a coarse random field,
    bicubically enlarged, plus a little noise): white noise would decode
    ~3x slower than a photo and time the wrong JPEG."""
    from PIL import Image

    coarse = rng.randint(0, 256, (max(h // 24, 2), max(w // 24, 2), 3)).astype(np.uint8)
    big = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.float32)
    return np.clip(big + rng.normal(0, 6, big.shape), 0, 255).astype(np.uint8)


def write_jpeg(path, rgb, quality=90):
    from PIL import Image

    Image.fromarray(rgb).save(path, format="JPEG", quality=quality)
    return str(path)


def write_devkit(root, seed, n_images=RUN_TEST_IMAGES, shapes=((600, 800), (800, 600)),
                 jpegs=False):
    """A synthetic VOCdevkit under ``root``: annotations and image sets of
    VOC2007 trainval/test and VOC2012 trainval, images of the (h, w)
    ``shapes`` in turn with 1-3 boxes each; with ``jpegs`` a JPEG file for
    every image (``natural_image``), else no image files."""
    from unit_tpu_torch.models.similarity import VOC_CLASSES

    rng = np.random.RandomState(seed + 11)
    pixels = np.random.RandomState(seed + 12)
    for year, splits in (("2007", ("trainval", "test")), ("2012", ("trainval",))):
        base = Path(root) / f"VOC{year}"
        for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
            (base / sub).mkdir(parents=True)
        for split in splits:
            ids = []
            for i in range(n_images):
                h, w = shapes[i % len(shapes)]
                image_id = f"{year}_{split}_{i:03d}"
                ids.append(image_id)
                if jpegs:
                    write_jpeg(base / "JPEGImages" / f"{image_id}.jpg", natural_image(pixels, h, w))
                objs = []
                for _ in range(rng.randint(1, 4)):
                    bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
                    x1, y1 = rng.randint(1, w - bw), rng.randint(1, h - bh)
                    objs.append(_OBJ.format(name=VOC_CLASSES[rng.randint(len(VOC_CLASSES))],
                                            x1=x1, y1=y1, x2=x1 + bw, y2=y1 + bh))
                (base / "Annotations" / f"{image_id}.xml").write_text(
                    _XML.format(w=w, h=h, objects="\n".join(objs)))
            (base / "ImageSets" / "Main" / f"{split}.txt").write_text("\n".join(ids))
    return str(root)


def seeded_image_loader(rec):
    """Float BGR content made from the record's id."""
    rng = np.random.RandomState(zlib.crc32(rec["image_id"].encode()) % 2 ** 31)
    return rng.uniform(0, 255, (rec["height"], rec["width"], 3)).astype(np.float32)


def loop_turn(trainer, losses, secs, dev):
    """One run-loop turn of a ``loop_recording`` trainer: its depth, the
    windowed step ms over the second half of its steps, each step's
    launches, its losses (without data_time) and the data wait of the
    window's steps, the profiled window's busy ms and share, and the
    device's peak memory of the run."""
    import torch

    half = len(trainer.starts) // 2
    return {"depth": trainer.metrics_pipeline_depth, "ms": trainer.window_ms(half),
            "launches": trainer.launches, "busy": trainer.busy, "secs": secs,
            "losses": [{k: v for k, v in losses[s].items() if k != "data_time"}
                       for s in sorted(losses)],
            "waits": [1e3 * losses[s]["data_time"] for s in sorted(losses)[half:]],
            "peak": torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0}


def depth_turns(tag, turns, steps, images):
    """Print the run loop's turns at each depth and gate them: the losses of
    every step bit-identical and the launches of every step the same in
    every turn, the peak device memory of the two depths within PEAK_REL."""
    for i, t in enumerate(turns):
        busy = (f"; under the profiler, the last {PROFILED_STEPS} steps and the drain: device "
                f"busy {t['busy'][0]:.2f} ms, {100 * t['busy'][1]:.1f}% of the window"
                if t["busy"] else "")
        log(f"{tag} turn {i + 1}, metrics_pipeline_depth {t['depth']}: {steps} steps in "
            f"{t['secs']:.1f} s with the runner's set-up (no final evaluation); the last "
            f"{steps - steps // 2} steps and the drain {t['ms']:.2f} ms a step "
            f"({images * 1e3 / t['ms']:.2f} images/s), data wait median "
            f"{np.median(t['waits']):.2f} ms; peak device memory {t['peak'] / 2**30:.3f} GiB"
            + busy)
    depths = sorted({t["depth"] for t in turns})
    lo, hi = depths[0], depths[-1]
    # like against like: the turns without the profiler, then those under it
    ms = {(d, p): float(np.median([t["ms"] for t in turns
                                   if t["depth"] == d and bool(t["busy"]) == p]))
          for d in depths for p in (False, True) if any(
              t["depth"] == d and bool(t["busy"]) == p for t in turns)}
    peak = {d: max(t["peak"] for t in turns if t["depth"] == d) for d in depths}
    same_losses = all(t["losses"] == turns[0]["losses"] for t in turns)
    same_launches = all(t["launches"] == turns[0]["launches"] for t in turns)
    peak_rel = abs(peak[hi] - peak[lo]) / max(peak[lo], 1)
    pairs = "; ".join(
        f"{label} {ms[hi, p]:.2f} vs {ms[lo, p]:.2f} ms ({100 * (ms[hi, p] / ms[lo, p] - 1):+.1f}%)"
        for p, label in ((False, "windowed step"), (True, "under the profiler"))
        if (hi, p) in ms and (lo, p) in ms)
    log(f"{tag} depth {hi} against {lo}: {pairs}; every step's losses bit-identical "
        f"{same_losses}; launches a step equal {same_launches} ({turns[0]['launches'][-1]}); "
        f"peak memory {peak[hi] / 2**30:.3f} vs {peak[lo] / 2**30:.3f} GiB "
        f"({100 * peak_rel:.2f}%, tol {100 * PEAK_REL:.0f}%)")
    if not (same_losses and same_launches and peak_rel <= PEAK_REL):
        raise AssertionError(f"{tag}: the depths' turns differ in losses, launches or peak "
                             f"memory")
    return {d: ms[d, False] for d in depths if (d, False) in ms}


def payload_equal(a, b) -> bool:
    """Two checkpoint payloads equal: every tensor bit for bit, every other value."""
    import torch

    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            payload_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(payload_equal, a, b))
    return a == b


def background_save(state, directory, dev):
    """Phase 10's checkpoint writes of a trainer's ``state`` in
    ``directory``: a synchronous write (the payload and torch.save), then the
    background save: the ms save() takes to return and to land (wait()), the
    state changed in place right after save() returns, and the landed file
    gated equal to the synchronous write; a second background save of the
    changed state, timed (the pinned snapshot's memory then comes from the
    host allocator's cache).  Returns the ms."""
    import torch

    from unit_tpu_torch.checkpoint import Checkpointer, read_checkpoint
    from unit_tpu_torch.checkpoint.checkpointer import state_payload

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    ckpt = Checkpointer(directory)
    sync()
    t = time.perf_counter()
    payload = state_payload(state, ckpt.best_info)
    plain = os.path.join(directory, "synchronous.pt")
    torch.save(payload, plain)
    ms = {"synchronous": (time.perf_counter() - t) * 1e3}
    mib = sum(v.numel() * v.element_size() for v in payload["model"].values()) / 2**20
    mib += sum(v.numel() * v.element_size() for st in payload["optimizer"]["state"].values()
               for v in st.values() if torch.is_tensor(v)) / 2**20
    del payload
    for turn in (1, 2):
        sync()
        t = time.perf_counter()
        path = ckpt.save(RUN_STEPS + turn, state)
        ms[f"returned{turn}"] = (time.perf_counter() - t) * 1e3
        if turn == 1:  # the next step's in-place changes, queued behind the snapshot
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(1.0)
                for st in state.solver.optimizer.state.values():
                    for v in st.values():
                        if torch.is_tensor(v) and v.dim():
                            v.mul_(2.0)
        ckpt.wait()
        ms[f"landed{turn}"] = (time.perf_counter() - t) * 1e3
        if turn == 1:
            same = payload_equal(read_checkpoint(path), read_checkpoint(plain))
    log(f"[10] checkpoint (model, momentum, schedule, step; {mib:.1f} MiB of tensors, "
        f"{os.path.getsize(plain) / 2**20:.1f} MiB on disk): synchronous payload + torch.save "
        f"{ms['synchronous']:.1f} ms; background save returned in {ms['returned1']:.1f} ms "
        f"and landed (wait()) at {ms['landed1']:.1f} ms, a second one {ms['returned2']:.1f} "
        f"and {ms['landed2']:.1f} ms; the landed file equal to the synchronous write of the "
        f"state it was taken from, though the state changed as save() returned: {same}")
    if not same:
        raise AssertionError("the background checkpoint is not the state at save()")
    return ms


def phase_run_loop(cfg, seed, workdir):
    """Phase 10 in the directory ``workdir``; phase 11 fine-tunes from the run
    it leaves in ``workdir/run_a``."""
    import torch

    from unit_tpu_torch.checkpoint import Checkpointer, read_checkpoint
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import TrainState
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.solver import build_optimizer
    from unit_tpu_torch.utils.bn_fold import fold_frozen_bn

    dev = torch.device(RUN_DEVICE)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    made = []
    Recording = loop_recording(made)

    def strip_time(results):
        return {k: v for k, v in results.items() if k != "inference_seconds_per_image"}

    tmp = workdir
    devkit = write_devkit(os.path.join(tmp, "VOCdevkit"), seed)
    out_a, out_b = os.path.join(tmp, "run_a"), os.path.join(tmp, "run_b")
    # The recipe starts from ImageNet weights, which are not in the
    # repository: the run warm-starts from one of the port's own
    # checkpoints instead (MODEL.WEIGHTS), holding the seeded weights with
    # calibrated FrozenBN statistics, and clips its gradients as phase 7.
    t0 = time.perf_counter()
    model = flagship_model(cfg, seed, dev)
    init = Checkpointer(os.path.join(tmp, "init")).save(
        0, TrainState(model, build_optimizer(cfg, model), 0), wait=True)
    del model
    torch.cuda.empty_cache()
    log(f"[10] devkit of {RUN_TEST_IMAGES} images a split and the initial checkpoint "
        f"({os.path.getsize(init) / 2**20:.1f} MiB) written in "
        f"{time.perf_counter() - t0:.1f} s")

    def run(out, *flags, opts=()):
        DatasetCatalog.clear()
        made.clear()
        args = runner.default_argument_parser().parse_args([
            "--config-file", str(FLAGSHIP), "--data-root", devkit, "--device", RUN_DEVICE,
            *flags,
            "MODEL.WEIGHTS", init, "OUTPUT_DIR", out,
            "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
            "DATASETS.CLASSIFIER_DATAROOT", devkit, "SEED", str(seed),
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(RUN_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(RUN_PERIOD), "TEST.EVAL_PERIOD", str(RUN_PERIOD),
            "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
            "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm", *RUN_EXTRA_OPTS, *opts])
        t = time.perf_counter()
        results = runner.run(args, image_loader=seeded_image_loader)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        trainer = made[-1]
        first = trainer.state.step - len(trainer.metrics_history)
        losses = {first + 1 + k: m for k, m in enumerate(trainer.metrics_history)}
        return results, losses, trainer, time.perf_counter() - t

    real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
    try:
        # (a) 6 steps, checkpoints and evaluations at 3 and 6, a final evaluation
        reset_launch_counts()
        results_a, losses_a, trainer, secs = run(out_a)
        launches = read_launch_counts()
        log(f"[10] run of {RUN_STEPS} steps with 2 in-run evaluations and the final one "
            f"over {RUN_TEST_IMAGES} images: {secs:.1f} s; launches {launches}")
        for step, m in losses_a.items():
            log(f"[10]   step {step}: " + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
        files = sorted(os.listdir(out_a))
        bbox = results_a["bbox"]
        log(f"[10] output directory: {files}; AP {bbox['AP']:.4g}, AP50 {bbox['AP50']:.4g}, "
            f"AP75 {bbox['AP75']:.4g}, novel_mean {bbox['novel_mean']:.4g}; "
            f"{results_a['inference_seconds_per_image']:.4f} s per evaluated image (host "
            f"clock, after one warm-up image); data time per step, median "
            f"{1e3 * np.median([m['data_time'] for m in losses_a.values()]):.2f} ms")
        need = {"step_3.pt", "step_6.pt", "best", "best_info.json", "log.txt"}
        ok = (need <= set(files) and sorted(losses_a) == list(range(1, RUN_STEPS + 1))
              and all(np.isfinite(v) for m in losses_a.values() for v in m.values())
              and all(np.isfinite(bbox[k]) for k in ("AP", "AP50", "AP75", "novel_mean"))
              and np.isfinite(results_a["inference_seconds_per_image"])
              and all(launches[k] > 0 for k in ("roi_align_fwd", "roi_align_bwd",
                                                "nms_mask", "bn_act_fwd", "bn_act_bwd")))
        if not ok:
            raise AssertionError("the run loop left out a checkpoint, a step, a finite "
                                 "result or a kernel")
        background_save(trainer.state, os.path.join(tmp, "timed"), dev)
        del trainer

        # (b) resume from a copy that holds only step 3
        os.makedirs(out_b)
        shutil.copy(os.path.join(out_a, "step_3.pt"), out_b)
        results_b, losses_b, trainer, secs = run(out_b, "--resume")
        del trainer
        rel = max(abs(losses_b[s][k] - losses_a[s][k]) / max(abs(losses_a[s][k]), 1e-12)
                  for s in losses_b for k in losses_b[s] if k != "data_time")
        same = all(losses_b[s][k] == losses_a[s][k] for s in losses_b
                   for k in losses_b[s] if k != "data_time")
        ma = read_checkpoint(os.path.join(out_a, "step_6.pt"))["model"]
        mb = read_checkpoint(os.path.join(out_b, "step_6.pt"))["model"]
        same_params = all(torch.equal(ma[k], mb[k]) for k in ma)
        log(f"[10] resumed from step 3 in {secs:.1f} s: steps {sorted(losses_b)}, losses "
            f"bit-identical to the uninterrupted run's {same} (max rel diff {rel:.3g}, "
            f"tol {RESUME_LOSS_RTOL}), final parameters bit-identical {same_params}, "
            f"final AP equal {strip_time(results_b) == strip_time(results_a)}")
        if sorted(losses_b) != list(range(RUN_PERIOD + 1, RUN_STEPS + 1)) \
                or not rel <= RESUME_LOSS_RTOL:
            raise AssertionError("the resumed run does not reproduce steps 4-6")

        # (c) --eval-only from the step-6 checkpoint equals the in-run evaluation
        results_c, losses_c, trainer, secs = run(out_a, "--eval-only", "--resume")
        del trainer
        log(f"[10] --eval-only from step 6 in {secs:.1f} s: results equal to the in-run "
            f"evaluation bit for bit {strip_time(results_c) == strip_time(results_a)}")
        if losses_c or strip_time(results_c) != strip_time(results_a):
            raise AssertionError("--eval-only does not reproduce the in-run evaluation")

        # (d) one evaluation with FrozenBN folded into the convolutions
        results_d, _, trainer, secs = run(out_a, "--eval-only", "--resume",
                                          opts=["TPU.FOLD_BN_AT_EVAL", "True"])
        net = trainer.model
        del trainer
        s = prepare_test_image(seeded_image_loader(
            {"image_id": "fold", "height": 600, "width": 800}),
            TransformConfig.test_from_cfg(cfg))
        img = torch.as_tensor(s["image"][None], device=dev)
        size = torch.as_tensor(s["image_size"][None], device=dev)
        cfg32 = cfg.clone()
        cfg32.TPU.COMPUTE_DTYPE = "float32"
        net32 = WSRCNN(ModelConfig.from_cfg(cfg32)).to(dev).eval()
        net32.load_state_dict(net.state_dict())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            feats = {name: m.predict_raw(img, size)[3].float()
                     for name, m in (("bf16", net), ("bf16 folded", fold_frozen_bn(net)),
                                     ("f32", net32), ("f32 folded", fold_frozen_bn(net32)))}
        ref = feats["f32"]
        rel32 = float((feats["f32 folded"] - ref).abs().max() / ref.abs().max())
        far = {k: float((feats[k] - ref).abs().mean() / ref.abs().mean())
               for k in ("bf16", "bf16 folded")}
        log(f"[10] TPU.FOLD_BN_AT_EVAL evaluation in {secs:.1f} s: AP50 "
            f"{results_d['bbox']['AP50']:.4g} (unfolded {bbox['AP50']:.4g}), "
            f"{results_d['inference_seconds_per_image']:.4f} s per image; res4 features of "
            f"one image, folded vs unfolded in f32: max|diff|/max {rel32:.3g} (tol "
            f"{FOLD_F32_REL}); mean|diff|/mean|f32| from the f32 features: bf16 "
            f"{far['bf16']:.3g}, bf16 folded {far['bf16 folded']:.3g} (tol "
            f"{FOLD_BF16_FACTOR} x the unfolded)")
        if not (np.isfinite(results_d["bbox"]["AP50"]) and rel32 <= FOLD_F32_REL
                and far["bf16 folded"] <= FOLD_BF16_FACTOR * far["bf16"]):
            raise AssertionError("the folded evaluation is not finite or not close")
        del net, net32, feats
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

        # (e) the loader's steady rate: more steps, no checkpoint or evaluation
        # between them, so the prefetch queues drain to what the host can
        # make; at each depth of the deferred loss fetch in turns
        turns = []
        for i, depth in enumerate(DEPTH_TURNS):
            Recording.depth, Recording.profile_last = depth, PROFILED_STEPS * (i >= 2)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with no_final_evaluation(runner):
                _, losses_e, trainer, secs = run(
                    os.path.join(tmp, f"run_e{i}"),
                    opts=["SOLVER.MAX_ITER", str(RUN_STEADY_STEPS),
                          "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0"])
            turns.append(loop_turn(trainer, losses_e, secs, dev))
            del trainer
            if len(losses_e) != RUN_STEADY_STEPS:
                raise AssertionError("the steady run did not take its steps")
        depth_turns("[10] (e)", turns, RUN_STEADY_STEPS, 4)
    finally:
        runner.TrainerNoMeta = real_trainer
        made.clear()
        torch.cuda.empty_cache()
    return launches


def phase_finetune(cfg, seed, workdir):
    """Phase 11: k-shot fine-tuning from phase 10's run in ``workdir``.
    (a) engine.runner.run on the shipped 10-shot split1 fine-tune recipe,
    warm-started from ``run_a/best/model`` as the recipe spells it; (b) timed
    fine-tune steps at the recipe's 8 images; (c) the fine-tune path in f32
    with the kernels vs their plain versions.  Returns (a)'s launch counts."""
    import torch

    from unit_tpu_torch.checkpoint import read_checkpoint
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import TrainerFineTune
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device(RUN_DEVICE)
    devkit = os.path.join(workdir, "VOCdevkit")
    base = os.path.join(workdir, "run_a", "best", "model")  # the port wrote model.pt there
    opts = ["MODEL.WEIGHTS", base, "OUTPUT_DIR", os.path.join(workdir, "ft"),
            "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
            "SEED", str(seed), "SOLVER.MAX_ITER", str(RUN_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(RUN_PERIOD), "TEST.EVAL_PERIOD", str(RUN_PERIOD),
            # random base weights: the gradients are clipped as in phases 7 and 10
            "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
            *RUN_EXTRA_OPTS]
    ft_cfg = get_cfg()
    ft_cfg.merge_from_file(str(FT_RECIPE))
    ft_cfg.merge_from_list(opts)
    made, warm = [], []

    class Recording(TrainerFineTune):
        """TrainerFineTune that keeps itself, so the script can read its state."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    real_trainer, real_merge = runner.TrainerFineTune, runner.merge_params_from_checkpoint

    def merge(model, path):
        out = real_merge(model, path)
        warm.append((path, out[1], out[2]))
        return out

    # (a) the run: 6 steps, checkpoints and evaluations every 3, the final one
    DatasetCatalog.clear()
    args = runner.default_argument_parser().parse_args(
        ["--config-file", str(FT_RECIPE), "--data-root", devkit, "--device", RUN_DEVICE, *opts])
    runner.TrainerFineTune, runner.merge_params_from_checkpoint = Recording, merge
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        results = runner.run(args, image_loader=seeded_image_loader)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launch_counts()
    finally:
        runner.TrainerFineTune, runner.merge_params_from_checkpoint = real_trainer, real_merge
    trainer = made[-1]
    model = trainer.model
    (path, loaded, skipped), = warm
    snapshot = read_checkpoint(path)["model"]
    final = {k: v.cpu() for k, v in model.state_dict().items()}
    new = sorted(k for k in final if k not in snapshot)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    log(f"[11] {FT_RECIPE.relative_to(ROOT)}: warm start from {path}: {loaded} tensors "
        f"loaded, {len(skipped)} of the snapshot skipped, {len(new)} new ones kept at their "
        f"zero initialisation {new}; trainable {len(trainable)} tensors "
        f"({sorted({n.rsplit('.', 1)[0] for n in trainable})}), "
        f"{ft_cfg.SOLVER.IMS_PER_BATCH} images a step, weak stream {trainer.weak_iter}")
    log(f"[11] run of {RUN_STEPS} steps with 2 in-run evaluations and the final one: "
        f"{secs:.1f} s; launches {launches}")
    for step, m in enumerate(trainer.metrics_history, 1):
        log(f"[11]   step {step}: " + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
    bbox = results["bbox"]
    log(f"[11] AP {bbox['AP']:.4g}, AP50 {bbox['AP50']:.4g}, novel_mean "
        f"{bbox['novel_mean']:.4g}; {results['inference_seconds_per_image']:.4f} s per "
        f"evaluated image")
    want_trainable = {n for n in final if n.startswith(("rpn_head.", "supervised.cls_score_ft.",
                                                        "supervised.bbox_pred_ft."))}
    changed = [k for k in snapshot if k not in trainable and not torch.equal(final[k], snapshot[k])]
    unmoved = [k for k in trainable
               if torch.equal(final[k], snapshot[k] if k in snapshot else torch.zeros_like(final[k]))]
    log(f"[11] frozen tensors bit-identical to the base snapshot: "
        f"{len(snapshot) - len(trainable & set(snapshot)) - len(changed)}/"
        f"{len(snapshot) - len(trainable & set(snapshot))}; trainable tensors moved: "
        f"{len(trainable) - len(unmoved)}/{len(trainable)}")
    if not (path == base + ".pt" and trainer.weak_iter is None and not skipped
            and set(new) == {n for n in want_trainable if "_ft." in n}
            and trainable == want_trainable and not changed and not unmoved
            and len(trainer.metrics_history) == RUN_STEPS
            and all(np.isfinite(v) for m in trainer.metrics_history for v in m.values())
            and all(np.isfinite(bbox[k]) for k in ("AP", "AP50", "novel_mean"))):
        raise AssertionError(f"the fine-tune run: warm start {path}, new {new}, trainable "
                             f"{sorted(trainable ^ want_trainable)} off the recipe, frozen "
                             f"tensors changed {changed[:5]}, trainable unmoved {unmoved[:5]}")
    # the freeze lists reach autograd: no backward through ROIAlign or an epilogue
    if not (launches["roi_align_fwd"] > 0 and launches["nms_mask"] > 0
            and launches["bn_act_fwd"] > 0 and launches["roi_align_bwd"] == 0
            and launches["bn_act_bwd"] == 0):
        raise AssertionError(f"the fine-tune run's launches: {launches}")
    del trainer, made[:]

    # (b) timed steps from pre-made batches of the recipe's 8 images
    solver = build_optimizer(ft_cfg, model)
    strong, _ = synthetic_train_batches(ft_cfg, seed, per_stream=FT_IMAGES)
    ft = TrainerFineTune(model, solver, itertools.cycle(strong), seed=seed)
    ft.init_state()

    def step(label):
        t = time.perf_counter()
        m = ft.run_step().resolve()  # read now: the clock holds the device's time
        ms = (time.perf_counter() - t) * 1e3
        log(f"[11] step {ft.state.step} ({label}) {ms:.1f} ms: "
            + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
        return ms

    for _ in range(TRAIN_WARMUP):
        step("warm-up")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = [step("timed") for _ in range(TRAIN_STEPS)]
    steps = read_launch_counts()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    med = float(np.median(times))
    log(f"[11] {TRAIN_STEPS} timed fine-tune steps ({model.mc.compute_dtype}, "
        f"{FT_IMAGES} strong images a step): median {med:.2f} ms (min {min(times):.2f}, max "
        f"{max(times):.2f}), {1e3 * FT_IMAGES / med:.2f} images/s, peak device memory "
        f"{peak / 2**20:.1f} MiB")
    n_backbone, n_res5, _ = frozen_bn_counts(model)
    k4 = n_backbone + (2 if model.mc.multi_box_head else 1) * n_res5
    per_step = {k: v / TRAIN_STEPS for k, v in steps.items()}
    log(f"[11] launches a step: {per_step}")
    want = {"roi_align_fwd": TRAIN_STEPS, "roi_align_bwd": 0, "nms_mask": TRAIN_STEPS,
            "nms_mask_images": FT_IMAGES * TRAIN_STEPS, "bn_act_fwd": k4 * TRAIN_STEPS,
            "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    if steps != want:
        raise AssertionError(f"a fine-tune step did not run K1 x1, K3 x1 ({FT_IMAGES} images), "
                             f"K4 x{k4} forward and no K2 or K4 backward: {steps}")
    profile_run(ft.run_step, "[11]", "fine-tune step", top=15)
    del ft, solver, model, strong
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (c) the whole fine-tune path in f32 with non-zero *_ft heads
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg32 = ft_cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model = flagship_model(cfg32, seed, dev)
    gen = torch.Generator().manual_seed(seed + 3)
    with torch.no_grad():
        for head in (model.supervised.cls_score_ft, model.supervised.bbox_pred_ft):
            for p in (head.weight, head.bias):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
    build_optimizer(cfg32, model)  # the recipe's freeze lists
    strong, _ = synthetic_train_batches(cfg32, seed + 1, n_batches=1, per_stream=FT_IMAGES)
    strong = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    kernels = train_path_kernels_vs_plain(model, strong, None, seed, "[11]")
    log(f"[11] launches of the f32 pass with kernels: {kernels}")
    if (kernels["roi_align_fwd"], kernels["roi_align_bwd"], kernels["nms_mask"],
            kernels["bn_act_bwd"]) != (1, 0, 1, 0):
        raise AssertionError(f"the f32 fine-tune pass's launches: {kernels}")
    del model
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def phase_coco_segm(seed, workdir):
    """Phase 12: COCO detection and instance segmentation on the card, the
    R-50-C4 segm recipe at full width and depth (80 classes, the mask head,
    seeded weights, calibrated FrozenBN, GloVe, bf16).  (a) served requests;
    (b) the f32 serving path with masks, kernels vs plain versions, and K1 at
    the mask path's own input; (c) timed train steps with gt_masks, one
    profiled, and the f32 train path kernels vs plain; (d) engine.runner.run
    on a shapes-COCO devkit: the segm recipe, then the segm-ft recipe from
    its best/model, and timed fine-tune steps.  Returns ({path: launch
    counts}, K1's mask-path numbers)."""
    import runpy

    import torch

    from unit_tpu_torch.checkpoint import Checkpointer, read_checkpoint
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import TrainerFineTune, TrainerNoMeta, TrainState
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.models.similarity import COCO_CLASSES
    from unit_tpu_torch.serving import DetectionService
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_mib():
        return torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    cfg = get_cfg()
    cfg.merge_from_file(str(COCO_SEGM))
    cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    by_path = {}

    # (a) served requests
    t0 = time.perf_counter()
    model = flagship_model(cfg, seed, dev)
    mc = model.mc
    log(f"[12] {COCO_SEGM.relative_to(ROOT)}: R-{mc.depth}-C4 built in "
        f"{time.perf_counter() - t0:.1f} s: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}"
        f" M params, {mc.num_classes} classes ({len(mc.novel_ids)} novel), mask head "
        f"{type(model.mask_head).__name__} (delta {mc.mask_head_finetune}), compute "
        f"{mc.compute_dtype}, multi_box_head {mc.multi_box_head}, transfer {mc.sim.terms}")
    svc = DetectionService(cfg, model, class_names=COCO_CLASSES)
    t0 = time.perf_counter()
    svc.warmup()
    sync()
    log(f"[12] warm-up, one request per orientation: {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(seed + 12)
    shapes = [(480, 640), (640, 480)]
    images = [rng.uniform(0, 255, shapes[i % 2] + (3,)).astype(np.float32)
              for i in range(COCO_REQUESTS)]
    reset_peak()
    reset_launch_counts()
    lat, results = [], []
    for img in images:
        t0 = time.perf_counter()
        results.append(svc.detect_array(img))  # ends in a device-to-host copy
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = read_launch_counts()
    log(f"[12] {COCO_REQUESTS} requests, latency ms {[round(v, 2) for v in lat]}, median "
        f"{np.median(lat):.2f}, peak device memory {peak_mib():.1f} MiB; detections per "
        f"request {[len(r) for r in results]}")
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)
    # the backbone, the box head (and the weak one) over the proposals, and
    # Res5 again over the final detections for the mask head
    k4 = n_backbone + (2 if mc.multi_box_head else 1) * n_res5 + n_res5
    log(f"[12] launches during the requests: {launches}; FrozenBN modules: backbone "
        f"{n_backbone}, one Res5 {n_res5} -> {k4} K4 launches a request")
    want = {"roi_align_fwd": 2 * COCO_REQUESTS, "roi_align_bwd": 0,
            "nms_mask": 2 * COCO_REQUESTS, "nms_mask_images": 2 * COCO_REQUESTS,
            "bn_act_fwd": k4 * COCO_REQUESTS, "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    if launches != want:
        raise AssertionError(f"a segm request did not run K1 x2 (proposals, final boxes), K3 "
                             f"x2 and K4 x{k4}: {launches}")
    by_path["coco_segm"] = launches
    for img, dets in zip(images, results):
        h, w = img.shape[:2]
        for d in dets:
            x1, y1, x2, y2 = d["box"]
            if not (np.isfinite(d["box"]).all() and 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
                    and 0 < d["score"] <= 1 and 0 <= d["class_id"] < mc.num_classes):
                raise AssertionError(f"a detection outside the image or range: {d}")
    # K1 at the mask path's own input: the res4 map of one request and its
    # final boxes, the padded rows of invalid detections among them
    s = prepare_test_image(images[0], svc.tcfg)
    img = torch.as_tensor(s["image"][None], device=dev)
    size = torch.as_tensor(s["image_size"][None], device=dev)
    with torch.inference_mode():
        feats = model.predict_raw(img, size)[3]
        dets = model.predict(img, size)
    n_valid = int(dets.valid.sum())
    masks_ok = bool(torch.isfinite(dets.masks).all() and dets.masks.min() >= 0
                    and dets.masks.max() <= 1)
    log(f"[12] one request's masks {tuple(dets.masks.shape)} {dets.masks.dtype}, in [0, 1] and "
        f"finite {masks_ok}; {n_valid} valid detections of {dets.boxes.shape[1]}")
    if not masks_ok:
        raise AssertionError("mask probabilities out of range")
    k1_mask = {}
    if on_card:
        boxes = dets.boxes.float()
        label = (f"mask path {list(feats.shape)} x {boxes.shape[1]} final boxes "
                 f"({n_valid} valid)")
        err = k1_check(feats, boxes, label, tag="[12]")
        k_ms, p_ms, least = k1_timed(feats, boxes, label, tag="[12]")
        # the rows of invalid detections hold whatever box their slot points
        # at; all-zero rows as well, whether or not this request had any
        padded = boxes.clone()
        padded[:, boxes.shape[1] // 2:] = 0.0
        err = max(err, k1_check(feats, padded, f"mask path, the last {boxes.shape[1] // 2} "
                                f"rows zero boxes", tag="[12]"))
        k1_mask = {"mask_path_ms": k_ms, "mask_path_plain_ms": p_ms,
                   "mask_path_bound_ms": least["bound_ms"], "mask_path_max_abs_err": err}
    profile_run(lambda: svc.detect_array(images[0]), "[12]", "segm request")
    ckpt_model = model
    del svc, feats, dets

    # (b) the f32 serving path with masks, kernels vs plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    # random heads spread their probability over 81 classes and few scores
    # pass the recipe's 0.05: compare the detections above 0.01 instead
    cfg32.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.01
    model32 = flagship_model(cfg32, seed, dev)
    s = prepare_test_image(images[1], TransformConfig.test_from_cfg(cfg32))
    img = torch.as_tensor(s["image"][None], device=dev)
    size = torch.as_tensor(s["image_size"][None], device=dev)
    outs = {}
    for impl in ("cuda", "plain"):
        model32.mc = dataclasses.replace(model32.mc, roi_align_impl=impl, nms_impl=impl)
        set_bn_act_impl(model32, impl)
        with torch.inference_mode():
            outs[impl] = model32.predict(img, size)
    set_bn_act_impl(model32, "cuda")
    dk, dp = outs["cuda"], outs["plain"]
    same = torch.equal(dk.classes, dp.classes) and torch.equal(dk.valid, dp.valid)
    dbox = float((dk.boxes - dp.boxes).abs().max())
    dscore = float((dk.scores - dp.scores).abs().max())
    dmask = float((dk.masks - dp.masks).abs().max())
    log(f"[12] f32, TF32 off, predict with masks: classes and valid identical {same} "
        f"({int(dk.valid.sum())} valid); boxes max|diff| {dbox:.3g} px (tol {MASK_BOX_ATOL}), "
        f"scores {dscore:.3g}, mask probabilities {dmask:.3g} (tol {MASK_PROBS_ATOL})")
    if not (same and int(dk.valid.sum()) > 0 and dbox <= MASK_BOX_ATOL
            and dscore <= MASK_PROBS_ATOL and dmask <= MASK_PROBS_ATOL):
        raise AssertionError("the segm serving path with kernels disagrees with the plain path")
    del model32, outs, dk, dp
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # (c) train steps with gt_masks: 2 strong + 2 weak images, clipped as phase 7
    cfg_t = cfg.clone()
    cfg_t.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg_t.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    model = flagship_model(cfg_t, seed, dev)
    solver = build_optimizer(cfg_t, model)
    strong, weak = synthetic_train_batches(cfg_t, seed + 12)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)  # after the freezes

    def step(tr, label):
        t = time.perf_counter()
        m = tr.run_step().resolve()  # read now: the clock holds the device's time
        ms = (time.perf_counter() - t) * 1e3
        log(f"[12] step {tr.state.step} ({label}) {ms:.1f} ms: "
            + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
        return ms

    for _ in range(TRAIN_WARMUP):
        step(trainer, "warm-up")
    sync()
    reset_peak()
    reset_launch_counts()
    times = [step(trainer, "timed") for _ in range(COCO_TRAIN_STEPS)]
    launches = read_launch_counts()
    med = float(np.median(times))
    imgs = 2 * strong[0]["image"].shape[0]
    log(f"[12] {COCO_TRAIN_STEPS} timed segm train steps: median {med:.2f} ms (min "
        f"{min(times):.2f}, max {max(times):.2f}), {1e3 * imgs / med:.2f} images/s ({imgs} "
        f"per step), peak device memory {peak_mib():.1f} MiB")
    # K4 forward: the fused backbone pass, Res5 over the strong ROIs (its map
    # feeds the mask head and, averaged, the predictors) and over the weak
    # ROIs; backward: the trainable backbone and both Res5 passes
    k4_fwd = n_backbone + (2 if mc.multi_box_head else 1) * n_res5 + n_res5
    k4_bwd = n_trainable + 2 * n_res5
    per_step = {k: v / COCO_TRAIN_STEPS for k, v in launches.items()}
    log(f"[12] launches a step: {per_step} (want K1 2, K2 2, K3 1 for 4 images, K4 "
        f"{k4_fwd} forward and {k4_bwd} backward, 1 layout copy)")
    # one layout copy: the spatial mean after the weak stream's Res5 hands its
    # last epilogue an NCHW-contiguous gradient (phase 7 has two such means);
    # the strong stream's map reaches the mean and the mask head through a
    # permute, and its gradient comes back channels-last
    want = {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1, "nms_mask_images": 4,
            "bn_act_fwd": k4_fwd, "bn_act_bwd": k4_bwd, "bn_act_layout_copies": 1}
    if per_step != want:
        raise AssertionError(f"a segm train step's launches: {per_step}")
    by_path["coco_segm_train"] = launches
    if not all(np.isfinite(m.get("loss_mask", np.nan)) and all(np.isfinite(v) for v in m.values())
               for m in trainer.metrics_history):
        raise AssertionError("a segm train step without a finite loss_mask")
    profile_run(trainer.run_step, "[12]", "segm train step", top=15)
    del trainer, model, solver, strong, weak
    if on_card:
        torch.cuda.empty_cache()
    # the f32 segm train path with the kernels vs with the plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model32 = flagship_model(cfg32, seed, dev)
    build_optimizer(cfg32, model32)  # freezes the stem and res2
    strong, weak = synthetic_train_batches(cfg32, seed + 13, n_batches=1)
    strong = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    weak = {k: torch.as_tensor(v, device=dev) for k, v in weak[0].items()}
    train_path_kernels_vs_plain(model32, strong, weak, seed, "[12]")
    del model32, strong, weak
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    if on_card:
        torch.cuda.empty_cache()

    # (d) the run loop on a shapes-COCO devkit
    t0 = time.perf_counter()
    root = os.path.join(workdir, "shapes_coco")
    written = runpy.run_path(str(ROOT / "scripts" / "make_shapes_coco_torch.py"))[
        "write_shapes_coco"](root, COCO_TRAIN_IMAGES, COCO_VAL_IMAGES, COCO_IMAGE_SIZE, seed)
    init = Checkpointer(os.path.join(workdir, "coco_init")).save(
        0, TrainState(ckpt_model, build_optimizer(cfg, ckpt_model), 0), wait=True)
    del ckpt_model
    log(f"[12] shapes-COCO devkit {written} and the initial checkpoint written in "
        f"{time.perf_counter() - t0:.1f} s")
    emb = str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH)
    made, warm = [], []

    def recording(cls):
        class Recording(cls):
            """The runner's trainer, kept so that the script can read it."""

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)
        return Recording

    real = (runner.TrainerNoMeta, runner.TrainerFineTune, runner.merge_params_from_checkpoint)

    def merge(model, path):
        out = real[2](model, path)
        warm.append((path, out[1], out[2]))
        return out

    def run(config, out, *opts):
        DatasetCatalog.clear()
        made.clear()
        args = runner.default_argument_parser().parse_args([
            "--config-file", str(config), "--data-root", root, "--device", RUN_DEVICE,
            "OUTPUT_DIR", out, "MODEL.ROI_HEADS.EMBEDDING_PATH", emb,
            "DATASETS.CLASSIFIER_DATAROOT", root, "SEED", str(seed),
            "SOLVER.MAX_ITER", str(COCO_RUN_STEPS),
            "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
            *RUN_EXTRA_OPTS, *opts])
        t = time.perf_counter()
        results = runner.run(args)
        sync()
        return results, made[-1], time.perf_counter() - t

    def report(name, results, trainer, secs):
        for k, m in enumerate(trainer.metrics_history, 1):
            log(f"[12]   {name} step {k}: " + ", ".join(f"{n} {v:.4g}" for n, v in m.items()))
        aps = {task: {k: results[task][k] for k in ("AP", "AP50", "AP75", "novel_mean")}
               for task in ("bbox", "segm")}
        log(f"[12] {name}: {len(trainer.metrics_history)} steps in {secs:.1f} s; "
            + "; ".join(f"{task} " + ", ".join(f"{k} {v:.4g}" for k, v in r.items())
                        for task, r in aps.items()))
        if not (len(trainer.metrics_history) == COCO_RUN_STEPS
                and all(np.isfinite(v) for r in aps.values() for v in r.values())
                and all(np.isfinite(m.get("loss_mask", np.nan))
                        and all(np.isfinite(v) for v in m.values())
                        for m in trainer.metrics_history)):
            raise AssertionError(f"the {name} run: a step, a loss or an AP is missing or not "
                                 "finite")

    base = os.path.join(workdir, "coco_segm_base")
    runner.TrainerNoMeta, runner.TrainerFineTune = recording(TrainerNoMeta), recording(
        TrainerFineTune)
    runner.merge_params_from_checkpoint = merge
    try:
        results, trainer, secs = run(
            COCO_SEGM, base, "MODEL.WEIGHTS", init, "SOLVER.IMS_PER_BATCH", "2",
            "SOLVER.CHECKPOINT_PERIOD", str(COCO_RUN_PERIOD),
            "TEST.EVAL_PERIOD", str(COCO_RUN_PERIOD))
        report("segm base run", results, trainer, secs)
        del trainer
        best = os.path.join(base, "best", "model")  # the port wrote model.pt there
        warm.clear()
        reset_launch_counts()
        results, trainer, secs = run(
            COCO_SEGM_FT, os.path.join(workdir, "coco_segm_ft"), "MODEL.WEIGHTS", best,
            "SOLVER.CHECKPOINT_PERIOD", str(COCO_RUN_STEPS),
            "TEST.EVAL_PERIOD", str(COCO_RUN_STEPS))
        launches = read_launch_counts()
    finally:
        runner.TrainerNoMeta, runner.TrainerFineTune, runner.merge_params_from_checkpoint = real
    report("segm-ft run", results, trainer, secs)
    log(f"[12] segm-ft run launches {launches}")
    by_path["coco_segm_ft"] = launches
    model = trainer.model
    (path, loaded, skipped), = warm
    snapshot = read_checkpoint(path)["model"]
    final = {k: v.cpu() for k, v in model.state_dict().items()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    new = sorted(k for k in final if k not in snapshot)
    changed = [k for k in snapshot if k not in trainable and not torch.equal(final[k], snapshot[k])]
    heads = [k for k in trainable if k.startswith(("box_head.", "mask_head."))
             or "_ft." in k]
    unmoved = [k for k in heads
               if torch.equal(final[k], snapshot[k] if k in snapshot else torch.zeros_like(final[k]))]
    ft_cfg = get_cfg()
    ft_cfg.merge_from_file(str(COCO_SEGM_FT))
    ft_cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    fresh = WSRCNN(ModelConfig.from_cfg(ft_cfg),
                   generator=torch.Generator().manual_seed(seed)).state_dict()
    weak_head = [k for k in final if k.startswith("weak_box_head.")]
    weak_at_init = all(torch.equal(final[k], fresh[k]) for k in weak_head)
    log(f"[12] segm-ft warm start from {path}: {loaded} tensors loaded, {len(skipped)} of the "
        f"snapshot skipped, {len(new)} new ({sorted({k.rsplit('.', 1)[0] for k in new})}); "
        f"frozen tensors of the snapshot bit-identical "
        f"{len([k for k in snapshot if k not in trainable]) - len(changed)}/"
        f"{len([k for k in snapshot if k not in trainable])}; weak_box_head ({len(weak_head)} "
        f"tensors) bit-identical to its own initialisation {weak_at_init}; box_head, mask_head "
        f"and *_ft tensors moved {len(heads) - len(unmoved)}/{len(heads)}")
    if not (path == best + ".pt" and not skipped and not changed and weak_head and weak_at_init
            and not any(k in trainable for k in weak_head) and heads and not unmoved
            and any("predictor_delta" in k for k in heads)):
        raise AssertionError(f"the segm-ft warm start: changed {changed[:5]}, unmoved "
                             f"{unmoved[:5]}, skipped {skipped[:5]}")
    # the FT recipe freezes the backbone but not box_head: K4 runs backward
    # through the box head's Res5, and nothing runs backward through ROIAlign
    if not (launches["roi_align_bwd"] == 0 and launches["bn_act_bwd"] > 0
            and launches["roi_align_fwd"] > 0 and launches["nms_mask"] > 0):
        raise AssertionError(f"the segm-ft run's launches: {launches}")

    # timed fine-tune steps of the recipe's 8 images, from pre-made batches
    solver = build_optimizer(ft_cfg, model)
    strong, _ = synthetic_train_batches(ft_cfg, seed + 14, per_stream=FT_IMAGES)
    ft = TrainerFineTune(model, solver, itertools.cycle(strong), seed=seed)
    ft.init_state()
    step(ft, "fine-tune warm-up")
    sync()
    reset_peak()
    reset_launch_counts()
    times = [step(ft, "fine-tune timed") for _ in range(COCO_FT_STEPS)]
    steps = read_launch_counts()
    med = float(np.median(times))
    n_backbone, n_res5, _ = frozen_bn_counts(model)
    k4_fwd = n_backbone + (2 if model.mc.multi_box_head else 1) * n_res5
    per_step = {k: v / COCO_FT_STEPS for k, v in steps.items()}
    log(f"[12] {COCO_FT_STEPS} timed segm-ft steps ({FT_IMAGES} strong images): median "
        f"{med:.2f} ms, {1e3 * FT_IMAGES / med:.2f} images/s, peak device memory "
        f"{peak_mib():.1f} MiB; launches a step {per_step} (want K1 1, K2 0, K3 1 for "
        f"{FT_IMAGES} images, K4 {k4_fwd} forward and {n_res5} backward)")
    want = {"roi_align_fwd": 1, "roi_align_bwd": 0, "nms_mask": 1, "nms_mask_images": FT_IMAGES,
            "bn_act_fwd": k4_fwd, "bn_act_bwd": n_res5, "bn_act_layout_copies": 0}
    if per_step != want:
        raise AssertionError(f"a segm-ft step's launches: {per_step}")
    profile_run(ft.run_step, "[12]", "segm-ft step", top=15)
    del ft, solver, model, trainer, strong
    if on_card:
        torch.cuda.empty_cache()
    return by_path, k1_mask


def phase_weak_variants(seed, workdir):
    """Phase 13: the weak detector's alternatives at full width and depth
    (R-101, bf16, the flagship canvases, seeded weights, calibrated FrozenBN).
    (a) the PCL recipe: timed train steps with launch counts, one profiled,
    the PCL losses alone against the OICR losses on the same inputs (device
    time, device ops, no host sync), the f32 train path kernels vs plain;
    (b) WeakRCNN: served requests through make_predict_fn (predict_weak_only),
    the f32 request path kernels vs plain, TrainerOnlyWeak steps; then
    WeaklySupervisedRCNNRPN steps, and K3 against its plain version at the
    self-training predict's shape (2 weak images, 6000 -> 1000, one launch);
    (c) engine.runner.run with TrainerOnlyWeakFineTune on phase 10's devkit
    (the classifier split, with its boxes, as the strong stream).  Returns
    ({path: launch counts}, K3's numbers at the self-training shape)."""
    import torch

    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import (
        TrainerNoMeta,
        TrainerOnlyWeak,
        TrainerOnlyWeakFineTune,
    )
    from unit_tpu_torch.models import pcl as pcl_lib
    from unit_tpu_torch.models import weak_losses as weak_lib
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.models.similarity import VOC_CLASSES
    from unit_tpu_torch.ops import nms as nms_ops
    from unit_tpu_torch.serving import DetectionService
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def recipe(path, *opts):
        cfg = get_cfg()
        cfg.merge_from_file(str(path))
        cfg.merge_from_list([*RUN_EXTRA_OPTS, *opts])
        cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True  # random weights: clipped as in phase 7
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
        return cfg

    def steps(trainer, label, timed):
        """TRAIN_WARMUP + ``timed`` steps -> (timed step ms, launches a timed step)."""
        def one(kind):
            t = time.perf_counter()
            m = trainer.run_step().resolve()  # read now: the clock holds the device's time
            ms = (time.perf_counter() - t) * 1e3
            log(f"[13] {label} step {trainer.state.step} ({kind}) {ms:.1f} ms: "
                + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
            return ms

        for _ in range(TRAIN_WARMUP):
            one("warm-up")
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times = [one("timed") for _ in range(timed)]
        launches = read_launch_counts()
        med = float(np.median(times))
        peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0
        log(f"[13] {label}: {timed} timed steps, median {med:.2f} ms (min {min(times):.2f}, "
            f"max {max(times):.2f}), {4e3 / med:.2f} images/s (2 strong + 2 weak), peak "
            f"device memory {peak:.1f} MiB, launches a step "
            f"{ {k: v / timed for k, v in launches.items()} }")
        if not all(np.isfinite(v) for m in trainer.metrics_history for v in m.values()):
            raise AssertionError(f"{label}: a non-finite loss")
        return times, launches

    def want_per_step(k1, k2, k3, k3_images, k4_fwd, k4_bwd, copies, n):
        return {"roi_align_fwd": k1 * n, "roi_align_bwd": k2 * n, "nms_mask": k3 * n,
                "nms_mask_images": k3_images * n, "bn_act_fwd": k4_fwd * n,
                "bn_act_bwd": k4_bwd * n, "bn_act_layout_copies": copies * n}

    by_path = {}

    # (a) the PCL recipe: 2 strong + 2 weak images a step, as phase 7
    cfg = recipe(PCL_RECIPE)
    t0 = time.perf_counter()
    model = flagship_model(cfg, seed, dev)
    mc = model.mc
    solver = build_optimizer(cfg, model)
    strong, weak = synthetic_train_batches(cfg, seed + 13)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)
    log(f"[13] {PCL_RECIPE.relative_to(ROOT)}: R-{mc.depth}-C4 set up in "
        f"{time.perf_counter() - t0:.1f} s; weak detector {mc.weak_detector_type} "
        f"(k-means {mc.num_kmeans_cluster}, graph IoU {mc.graph_iou_threshold}, "
        f"{mc.max_pc_num} centers a class), {mc.weak_proposal_count} proposals a weak image, "
        f"compute {mc.compute_dtype}")
    captured = []
    real_pcl = pcl_lib.pcl_detector_losses

    def capture(*a, **kw):
        captured[:] = [(a, kw)]
        return real_pcl(*a, **kw)

    pcl_lib.pcl_detector_losses = capture
    try:
        _, launches = steps(trainer, "PCL train", WEAK_TRAIN_STEPS)
    finally:
        pcl_lib.pcl_detector_losses = real_pcl
    want = want_per_step(2, 2, 1, 4, n_backbone + 3 * n_res5, n_trainable + 2 * n_res5, 2,
                         WEAK_TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"a PCL train step did not run K1 x2, K2 x2, K3 x1 (4 images), K4 "
                             f"x{n_backbone + 3 * n_res5} + x{n_trainable + 2 * n_res5} with 2 "
                             f"layout copies: {launches}")
    by_path["pcl_train"] = launches
    if on_card:
        step_profile = profile_run(trainer.run_step, "[13]", "PCL train step", top=12)

    # the PCL losses alone against the OICR losses, on one step's inputs
    (args, kwargs), = captured
    streams = {k: [x.detach().requires_grad_() for x in v] if isinstance(v, list)
               else v.detach().requires_grad_() for k, v in args[0].items()}
    rest = args[1:]

    def pcl_only():
        losses = real_pcl(streams, *rest, **kwargs)
        torch.stack(list(losses.values())).sum().backward()

    def oicr_only():
        losses = weak_lib.weak_detector_losses(streams, *rest[:4])
        torch.stack(list(losses.values())).sum().backward()

    present = rest[4]
    log(f"[13] PCL inputs: {tuple(rest[0].shape)} proposals, classes present {list(present)}")
    if on_card:
        torch.cuda.set_sync_debug_mode("error")  # any host sync raises
        try:
            pcl_only()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pcl_ms, oicr_ms = cuda_ms(pcl_only, 5), cuda_ms(oicr_only, 5)
        pcl_prof = profile_run(pcl_only, "[13]", "PCL losses + backward", top=6)
        oicr_prof = profile_run(oicr_only, "[13]", "OICR losses + backward", top=6)
        log(f"[13] PCL mining + losses + backward ran under sync debug mode 'error' (no host "
            f"sync); by CUDA events {pcl_ms:.2f} ms against OICR's {oicr_ms:.2f} ms on the same "
            f"inputs; device ops {pcl_prof['device_ops']} against {oicr_prof['device_ops']}: "
            f"+{pcl_prof['device_ops'] - oicr_prof['device_ops']} a step "
            f"({step_profile['device_ops']} in the profiled PCL step)")
    else:
        pcl_only()
        oicr_only()
    del trainer, model, solver, streams, captured[:]
    if on_card:
        torch.cuda.empty_cache()

    # the f32 PCL train path with the kernels vs with the plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = flagship_model(cfg32, seed, dev)
    build_optimizer(cfg32, model32)
    strong, weak = synthetic_train_batches(cfg32, seed + 14, n_batches=1)
    strong = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    weak = dict({k: torch.as_tensor(v, device=dev) for k, v in weak[0].items()},
                labels_host=torch.as_tensor(weak[0]["labels"]))
    train_path_kernels_vs_plain(model32, strong, weak, seed, "[13]")
    del model32, strong, weak
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    if on_card:
        torch.cuda.empty_cache()

    # (b) WeakRCNN: requests through make_predict_fn, which serves predict_weak_only
    cfg = recipe(FLAGSHIP, "MODEL.META_ARCHITECTURE", "WeakRCNN")
    model = flagship_model(cfg, seed, dev)
    svc = DetectionService(cfg, model, class_names=VOC_CLASSES)
    svc.warmup()
    rng = np.random.RandomState(seed + 13)
    shapes = [(375, 500), (500, 375)]
    images = [rng.uniform(0, 255, shapes[i % 2] + (3,)).astype(np.float32)
              for i in range(WEAK_REQUESTS)]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, results = [], []
    for img in images:
        t0 = time.perf_counter()
        results.append(svc.detect_array(img))  # ends in a device-to-host copy
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = read_launch_counts()
    head = n_res5  # the weak head alone scores the proposals
    log(f"[13] WeakRCNN: {WEAK_REQUESTS} requests, latency ms {[round(v, 2) for v in lat]}, "
        f"median {np.median(lat):.2f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0:.1f} MiB; detections "
        f"{[len(r) for r in results]}; launches {launches}")
    if launches != want_per_step(1, 0, 2, 2, n_backbone + head, 0, 0, WEAK_REQUESTS):
        raise AssertionError(f"a WeakRCNN request did not run K1 x1, K3 x2 and K4 "
                             f"x{n_backbone + head}: {launches}")
    by_path["weak_rcnn_serving"] = launches
    for img, dets in zip(images, results):
        h, w = img.shape[:2]
        for d in dets:
            x1, y1, x2, y2 = d["box"]
            # a score is a sum of OICR_ITER softmax probabilities
            if not (np.isfinite(d["box"]).all() and 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
                    and 0 < d["score"] <= mc.oicr_iter):
                raise AssertionError(f"a WeakRCNN detection outside the image or range: {d}")
    if on_card:
        profile_run(lambda: svc.detect_array(images[0]), "[13]", "WeakRCNN request", top=8)
    del svc

    # TrainerOnlyWeak on the same model: the RPN on the strong images, the
    # weak branch on the weak ones
    solver = build_optimizer(cfg, model)
    strong, weak = synthetic_train_batches(cfg, seed + 15)
    trainer = runner.trainer_class_for(cfg)(model, solver, itertools.cycle(strong),
                                            itertools.cycle(weak), seed=seed)
    if not isinstance(trainer, TrainerOnlyWeak):
        raise AssertionError(f"WeakRCNN trains with {type(trainer).__name__}")
    trainer.init_state()
    _, launches = steps(trainer, "TrainerOnlyWeak", WEAK_ONLY_STEPS)
    if set(trainer.metrics_history[-1]) != {"loss_rpn_cls", "loss_rpn_loc", "loss_im_cls",
                                            "loss_oicr_1", "loss_oicr_2", "loss_oicr_3",
                                            "total_loss", "data_time"}:
        raise AssertionError(f"TrainerOnlyWeak's losses: {sorted(trainer.metrics_history[-1])}")
    want = want_per_step(1, 1, 1, 2, n_backbone + n_res5, n_trainable + n_res5, 1,
                         WEAK_ONLY_STEPS)
    if launches != want:
        raise AssertionError(f"a TrainerOnlyWeak step did not run K1 x1, K2 x1, K3 x1 (the 2 "
                             f"weak images), K4 x{n_backbone + n_res5} + "
                             f"x{n_trainable + n_res5}: {launches}")
    by_path["weak_only_train"] = launches
    if on_card:
        profile_run(trainer.run_step, "[13]", "TrainerOnlyWeak step", top=8)
    del trainer, solver

    # the f32 request path with the kernels vs with the plain versions: the
    # proposals identical, the summed probabilities within OICR_ITER times
    # phase 5's bound
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = flagship_model(cfg32, seed, dev)
    s = prepare_test_image(images[1], TransformConfig.test_from_cfg(cfg32))
    img = torch.as_tensor(s["image"][None], device=dev)
    size = torch.as_tensor(s["image_size"][None], device=dev)
    recorded, real_final = {}, model32._final_detections

    def recording_final(impl):
        def final(probs, bbox, props, sizes):
            recorded[impl] = (probs, bbox, props)
            return real_final(probs, bbox, props, sizes)
        return final

    outs = {}
    for impl in ("cuda", "plain"):
        model32.mc = dataclasses.replace(model32.mc, roi_align_impl=impl, nms_impl=impl)
        set_bn_act_impl(model32, impl)
        model32._final_detections = recording_final(impl)
        with torch.inference_mode():
            outs[impl] = model32.predict_weak_only(img, size)
    del model32._final_detections
    set_bn_act_impl(model32, "cuda")
    (pk, bk, prk), (pp, bp, prp) = recorded["cuda"], recorded["plain"]
    same_props = torch.equal(prk.boxes, prp.boxes) and torch.equal(prk.valid, prp.valid)
    dprobs = float((pk - pp).abs().max())
    same_dets = all(torch.equal(getattr(outs["cuda"], f), getattr(outs["plain"], f))
                    for f in ("classes", "valid"))
    log(f"[13] f32, TF32 off, WeakRCNN request: proposals identical {same_props} "
        f"({int(prk.valid.sum())} valid); summed probabilities max|diff| {dprobs:.3g} (tol "
        f"{mc.oicr_iter * E2E_PROBS_ATOL}); box deltas equal {torch.equal(bk, bp)}; final "
        f"classes and valid identical {same_dets} ({int(outs['cuda'].valid.sum())} valid)")
    if not (same_props and dprobs <= mc.oicr_iter * E2E_PROBS_ATOL and torch.equal(bk, bp)):
        raise AssertionError("the WeakRCNN request path with kernels disagrees with the plain "
                             "path")
    del model32, recorded, outs
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    if on_card:
        torch.cuda.empty_cache()

    # WeaklySupervisedRCNNRPN: RPN losses on the weak images against the weak
    # detector's confident detections (threshold 0: a random detector never
    # reaches the recipe's 0.99, and its pseudo boxes would be none)
    cfg = recipe(FLAGSHIP, "MODEL.META_ARCHITECTURE", "WeaklySupervisedRCNNRPN",
                 "MODEL.PROPOSAL_GENERATOR.WEAK_RPN_SCORE_TRESHOLD", "0.0")
    model = flagship_model(cfg, seed, dev)
    solver = build_optimizer(cfg, model)
    strong, weak = synthetic_train_batches(cfg, seed + 16)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    k3_inputs = []
    real_k3 = nms_ops.nms_sorted_mask_cuda

    def record_k3(boxes, thr, cap=None, n_valid=None):
        # the one launch for 2 images: the predict's RPN NMS (the training
        # selection takes 4 images, the final NMS one)
        if boxes.dim() == 3 and boxes.shape[0] == 2 and not k3_inputs:
            k3_inputs.append((boxes.clone(), thr, cap,
                              None if n_valid is None else n_valid.clone()))
        return real_k3(boxes, thr, cap, n_valid=n_valid)

    nms_ops.nms_sorted_mask_cuda = record_k3
    try:
        _, launches = steps(trainer, "WeaklySupervisedRCNNRPN", WEAK_ONLY_STEPS)
    finally:
        nms_ops.nms_sorted_mask_cuda = real_k3
    # K1: the strong and weak ROIs and the predict's proposals; K3: the
    # training selection (4 images), the predict's RPN NMS (2 images) and
    # its final NMS (one launch an image); K4: the fused backbone, three
    # Res5 passes and the predict's weak head
    want = want_per_step(3, 2, 4, 8, n_backbone + 4 * n_res5, n_trainable + 2 * n_res5, 2,
                         WEAK_ONLY_STEPS)
    last = trainer.metrics_history[-1]
    if launches != want or not last.get("loss_rpn_loc_weak", 0.0) > 0.0:
        raise AssertionError(f"a WeaklySupervisedRCNNRPN step did not run K1 x3, K2 x2, K3 x4 "
                             f"(8 images), K4 x{n_backbone + 4 * n_res5} + "
                             f"x{n_trainable + 2 * n_res5}, or had no pseudo box: {launches}, "
                             f"{last}")
    by_path["self_training_train"] = launches
    if on_card:
        profile_run(trainer.run_step, "[13]", "WeaklySupervisedRCNNRPN step", top=8)
    del trainer, solver, model

    # K3 at the self-training predict's shape: 2 images x 6000 -> 1000 in ONE launch
    (boxes, thr, cap, n_valid), = k3_inputs
    got = real_k3(boxes, thr, cap, n_valid=n_valid)
    again = real_k3(boxes, thr, cap, n_valid=n_valid)
    plain = nms_ops.nms_sorted_mask_plain(boxes, thr, cap)
    err = float((got.float() - plain.float()).abs().max())
    k3_b2 = {}
    label = f"{list(boxes.shape)} -> {cap} at IoU {thr} (the self-training predict's RPN NMS)"
    if on_card:
        k_ms = cuda_ms(lambda: real_k3(boxes, thr, cap, n_valid=n_valid), 20)
        p_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask_plain(boxes, thr, cap), 2)
        least = bound(nms_bytes(boxes, got, cap, n_valid),
                      nms_pair_tests(got, cap, n_valid) * IOU_FLOPS)
        k3_b2 = {"self_training_b2_ms": k_ms, "self_training_b2_plain_ms": p_ms,
                 "self_training_b2_bound_ms": least["bound_ms"],
                 "self_training_b2_max_abs_err": err}
        log(f"[13] K3 {label}: {got.sum(1).tolist()} keeps, kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {least['bound_ms']:.5f} ms by {least['bound_by']}; max|diff| "
            f"{err}, two launches bit-identical {torch.equal(got, again)}")
    if err != 0.0 or not torch.equal(got, again):
        raise AssertionError(f"K3 differs from its plain version at {label}")
    # the same shape in phase 3's clustered RPN layout, where the cap is reached
    # (a random-weight RPN on white-noise training images decodes most anchors
    # onto a few boxes: few keeps above)
    n = boxes.shape[1]
    rng3 = np.random.RandomState(seed + 17)
    clustered = torch.as_tensor(np.stack([clustered_boxes(rng3, n) for _ in range(2)]),
                                device=dev)
    order = torch.argsort(torch.as_tensor(rng3.rand(2, n).astype(np.float32), device=dev),
                          dim=1, stable=True)
    clustered = clustered.gather(1, order[..., None].expand(-1, -1, 4)).contiguous()
    got = real_k3(clustered, thr, cap)
    if not torch.equal(got, nms_ops.nms_sorted_mask_plain(clustered, thr, cap)):
        raise AssertionError(f"K3 differs from its plain version at {label}, clustered boxes")
    if on_card:
        k_ms = cuda_ms(lambda: real_k3(clustered, thr, cap), 20)
        log(f"[13] K3 the same shape, clustered boxes: {got.sum(1).tolist()} keeps, identical to "
            f"the plain version, kernel {k_ms:.4f} ms")
    del k3_inputs[:], boxes, clustered
    if on_card:
        torch.cuda.empty_cache()

    # (c) TrainerOnlyWeakFineTune: run on phase 10's devkit, the classifier split
    made = []

    class Recording(TrainerOnlyWeakFineTune):
        """The runner's trainer, kept so that the script can read it."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    devkit = os.path.join(workdir, "VOCdevkit")
    DatasetCatalog.clear()
    args = runner.default_argument_parser().parse_args([
        "--config-file", str(FLAGSHIP), "--data-root", devkit, "--device", RUN_DEVICE,
        "MODEL.WEIGHTS", os.path.join(workdir, "run_a", "best", "model"),
        "OUTPUT_DIR", os.path.join(workdir, "only_weak_ft"),
        "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
        "DATASETS.CLASSIFIER_DATAROOT", devkit, "SEED", str(seed),
        "ENGINE.TRAINER", "TrainerOnlyWeakFineTune", "DATASETS.TRAIN", "()",
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(WEAK_RUN_STEPS),
        "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
        "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
        *RUN_EXTRA_OPTS])
    real_trainer, runner.TrainerOnlyWeakFineTune = runner.TrainerOnlyWeakFineTune, Recording
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        results = runner.run(args, image_loader=seeded_image_loader)
        sync()
        secs = time.perf_counter() - t0
        launches = read_launch_counts()
    finally:
        runner.TrainerOnlyWeakFineTune = real_trainer
    (trainer,) = made
    bbox = results["bbox"]
    for k, m in enumerate(trainer.metrics_history, 1):
        log(f"[13]   TrainerOnlyWeakFineTune step {k}: "
            + ", ".join(f"{n} {v:.4g}" for n, v in m.items()))
    log(f"[13] TrainerOnlyWeakFineTune run: {len(trainer.metrics_history)} steps and the "
        f"evaluation in {secs:.1f} s, AP {bbox['AP']:.4g}, AP50 {bbox['AP50']:.4g}; weak stream "
        f"{trainer.weak_iter}; launches {launches}")
    m = trainer.metrics_history[-1] if trainer.metrics_history else {}
    if not (trainer.weak_iter is None and len(trainer.metrics_history) == WEAK_RUN_STEPS
            and {"loss_rpn_cls", "loss_cls", "loss_box_reg"} <= set(m)
            and not any(k.startswith(("loss_oicr", "loss_im_cls")) for k in m)
            and all(np.isfinite(v) for mm in trainer.metrics_history for v in mm.values())
            and all(np.isfinite(bbox[k]) for k in ("AP", "AP50"))):
        raise AssertionError("the TrainerOnlyWeakFineTune run: a step, a loss or an AP is "
                             "missing, or a weak stream was built")
    by_path["only_weak_ft_run"] = launches
    del trainer, made[:]
    if on_card:
        torch.cuda.empty_cache()
    return by_path, k3_b2


def synthetic_support_batches(cfg, seed, n_batches=2, shots=None):
    """Support batches made from ``seed``: C base classes x ``shots`` (the
    recipe's NUM_SHOTS) shots of random BGR content on the square meta canvas,
    one GT box a shot, one shot in seven on the whole canvas (the loader's
    box for a record without one of its class)."""
    rng = np.random.RandomState(seed + 9)
    c = len(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
    k = shots or cfg.DATASETS.FEWSHOT.NUM_SHOTS
    m = cfg.INPUT.META_MIN_SIZE
    out = []
    for _ in range(n_batches):
        wh = rng.uniform(0.1, 0.9, (c, k, 2)) * m
        xy = rng.uniform(0, 1, (c, k, 2)) * (m - wh)
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        boxes.reshape(-1, 4)[::7] = [0, 0, m, m]
        out.append({"image": rng.uniform(0, 255, (c, k, m, m, 3)).astype(np.float32),
                    "boxes": boxes, "class_valid": np.ones(c, bool)})
    return out


def phase_meta(seed, workdir):
    """Phase 14: the meta recipe (VOC-RCNN-101-C4-split1-meta.yaml) at full
    width and depth (R-101, bf16, the flagship canvases, 15 base classes x 5
    shots at 224, seeded weights, calibrated FrozenBN).  (a) Trainer's timed
    steps with launch counts, all three streams in pinned memory, one
    profiled; (b) the f32 meta train path kernels vs plain, the rank losses'
    underflow constants exact; (c) K1 against its plain version at the
    support shapes: the step's own shots [75,14,14,1024] x 1 ROI and an
    evaluation's [750,14,14,1024] x 1; (d) engine.runner.run with Trainer on
    phase 10's devkit: 4 steps with a checkpoint at 2 and an evaluation with
    the support precompute, then a resume from step 2.  Returns ({path:
    launch counts}, K1's numbers at the support shapes)."""
    import torch

    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.loader import pin_batch
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import Trainer
    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    torch.backends.cudnn.deterministic = True

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = get_cfg()
    cfg.merge_from_file(str(META_RECIPE))
    cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True  # random weights: clipped as in phase 7
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    by_path = {}

    # (a) timed meta steps: 2 strong + 2 weak images and 15 x 5 shots a step
    t0 = time.perf_counter()
    model = flagship_model(cfg, seed, dev)
    mc = model.mc
    solver = build_optimizer(cfg, model)
    strong, weak = synthetic_train_batches(cfg, seed + 20)
    support = synthetic_support_batches(cfg, seed + 21)
    if on_card:  # the runner's Prefetcher pins every stream: no pageable upload in a step
        strong, weak, support = ([pin_batch(b) for b in s] for s in (strong, weak, support))
    trainer = Trainer(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                      meta_iter=itertools.cycle(support), seed=seed)
    trainer.init_state()
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)
    shots = support[0]["image"].shape
    log(f"[14] {META_RECIPE.relative_to(ROOT)}: R-{mc.depth}-C4 set up in "
        f"{time.perf_counter() - t0:.1f} s; attention {mc.attention_mode}, support "
        f"{list(shots)} ({shots[0] * shots[1]} shots a step), rank-loss slots "
        f"{mc.rank_loss_slots} an image, compute {mc.compute_dtype}")
    k1_inputs = []
    real_k1 = ra.roi_align_cuda

    def record_k1(feats, rois, *a):
        # the support stream's launch: one ROI for each of the C * K shots
        if rois.shape[1] == 1 and feats.shape[0] == shots[0] * shots[1] and not k1_inputs:
            k1_inputs.append((feats.clone(), rois.clone()))
        return real_k1(feats, rois, *a)

    def one(label):
        t = time.perf_counter()
        m = trainer.run_step().resolve()  # read now: the clock holds the device's time
        ms = (time.perf_counter() - t) * 1e3
        log(f"[14] meta step {trainer.state.step} ({label}) {ms:.1f} ms: "
            + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
        return ms

    ra.roi_align_cuda = record_k1
    try:
        for _ in range(TRAIN_WARMUP):
            one("warm-up")
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times = [one("timed") for _ in range(META_TRAIN_STEPS)]
        launches = read_launch_counts()
    finally:
        ra.roi_align_cuda = real_k1
    med = float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0
    log(f"[14] {META_TRAIN_STEPS} timed meta steps: median {med:.2f} ms (min {min(times):.2f}, "
        f"max {max(times):.2f}), {4e3 / med:.2f} images/s (2 strong + 2 weak, and "
        f"{shots[0] * shots[1]} shots), peak device memory {peak:.1f} MiB; launches a step "
        f"{ {k: v / META_TRAIN_STEPS for k, v in launches.items()} }")
    # K1: the strong and weak ROIs and the shots; K4: the fused backbone, the
    # shots' backbone (no graph), three Res5 passes and the meta head over the
    # shots and the query slots, each of those two with a backward
    k4_fwd, k4_bwd = 2 * n_backbone + 5 * n_res5, n_trainable + 4 * n_res5
    want = {"roi_align_fwd": 3, "roi_align_bwd": 2, "nms_mask": 1, "nms_mask_images": 4,
            "bn_act_fwd": k4_fwd, "bn_act_bwd": k4_bwd, "bn_act_layout_copies": 4}
    if launches != {k: v * META_TRAIN_STEPS for k, v in want.items()}:
        raise AssertionError(f"a meta step did not run K1 x3, K2 x2, K3 x1 (4 images), K4 "
                             f"x{k4_fwd} + x{k4_bwd} with 4 layout copies: {launches}")
    for m in trainer.metrics_history:
        if not (all(np.isfinite(v) for v in m.values())
                and m["loss_rank_margin"] == RANK_MARGIN_UNDERFLOW
                and m["loss_rank_reg"] == 1.0 and m["loss_rank_cls"] > 0):
            raise AssertionError(f"a meta step's losses are not finite or not the likelihood "
                                 f"underflow's constants: {m}")
    by_path["meta"] = launches
    if on_card:
        profile_run(trainer.run_step, "[14]", "meta train step", top=12)
    del trainer, solver, model
    if on_card:
        torch.cuda.empty_cache()

    # (b) the f32 meta train path with the kernels vs with the plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = flagship_model(cfg32, seed, dev)
    build_optimizer(cfg32, model32)
    strong, weak = synthetic_train_batches(cfg32, seed + 22, n_batches=1)
    strong = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    weak = {k: torch.as_tensor(v, device=dev) for k, v in weak[0].items()}
    meta = {k: torch.as_tensor(v, device=dev)
            for k, v in synthetic_support_batches(cfg32, seed + 23, n_batches=1)[0].items()}
    launches32 = train_path_kernels_vs_plain(model32, strong, weak, seed, "[14]", meta=meta)
    log(f"[14] f32 meta step launches with the kernels: {launches32}")
    del model32, strong, weak, meta
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    if on_card:
        torch.cuda.empty_cache()

    # (c) K1 at the support shapes: the step's own shots, and an evaluation's
    k1_support = {}
    if on_card:
        (feats, rois), = k1_inputs
        # K1's f32 bound is for features of order 1: the step's res4 maps are
        # scaled by the power of two nearest their RMS, which is exact and
        # leaves every rounding of the kernel and the plain version as it was
        rms = float(feats.float().square().mean().sqrt())
        feats = feats * 2.0 ** -round(np.log2(rms))
        label = (f"support {list(feats.shape)} x 1 ROI (a meta step's shots, RMS {rms:.4g} "
                 f"scaled to {float(feats.float().square().mean().sqrt()):.4g})")
        err = k1_check(feats, rois, label, tag="[14]")
        k_ms, p_ms, least = k1_timed(feats, rois, label, tag="[14]")
        rng = np.random.RandomState(seed + 24)
        big = synthetic_support_batches(cfg, seed + 25, n_batches=1,
                                        shots=cfg.DATASETS.BASE_META_SHOTS)[0]["boxes"]
        n = big.shape[0] * big.shape[1]
        feats = torch.as_tensor(rng.randn(n, *feats.shape[1:]).astype(np.float32),
                                device=dev).to(torch.bfloat16)
        rois = torch.as_tensor(big.reshape(n, 1, 4), device=dev)
        label = f"support {list(feats.shape)} x 1 ROI (an evaluation's shots)"
        err = max(err, k1_check(feats, rois, label, tag="[14]"))
        # the plain version takes ~1.5 s a call at this shape: one timed call
        k_big, p_big, least_big = k1_timed(feats, rois, label, tag="[14]", plain_iters=1)
        k1_support = {"support_b75_ms": k_ms, "support_b75_plain_ms": p_ms,
                      "support_b75_bound_ms": least["bound_ms"],
                      "support_b750_ms": k_big, "support_b750_plain_ms": p_big,
                      "support_b750_bound_ms": least_big["bound_ms"],
                      "support_max_abs_err": err}
        del feats, rois
        torch.cuda.empty_cache()
    del k1_inputs[:]

    # (d) engine.runner.run with Trainer on phase 10's devkit
    made = []

    class Recording(Trainer):
        """The runner's trainer, kept so that the script can read it."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    devkit = os.path.join(workdir, "VOCdevkit")
    out_a, out_b = os.path.join(workdir, "meta_a"), os.path.join(workdir, "meta_b")

    def run(out, *flags, opts=()):
        DatasetCatalog.clear()
        made.clear()
        args = runner.default_argument_parser().parse_args([
            "--config-file", str(META_RECIPE), "--data-root", devkit, "--device", RUN_DEVICE,
            *flags, "MODEL.WEIGHTS", os.path.join(workdir, "run_a", "best", "model"),
            "OUTPUT_DIR", out,
            "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
            "DATASETS.CLASSIFIER_DATAROOT", devkit, "SEED", str(seed),
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(META_RUN_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(META_RUN_STEPS // 2), "TEST.EVAL_PERIOD", "0",
            "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
            *RUN_EXTRA_OPTS, *opts])
        t = time.perf_counter()
        results = runner.run(args, image_loader=seeded_image_loader)
        sync()
        secs = time.perf_counter() - t
        trainer = made[-1]
        first = trainer.state.step - len(trainer.metrics_history)
        losses = {first + 1 + k: {n: v for n, v in m.items() if n != "data_time"}
                  for k, m in enumerate(trainer.metrics_history)}
        return results, losses, trainer, secs

    attention = []
    real_attention = runner.meta_attention

    def record_attention(*a, **kw):
        t = time.perf_counter()
        att = real_attention(*a, **kw)
        sync()
        attention.append((att, time.perf_counter() - t))
        return att

    real_trainer, runner.Trainer = runner.Trainer, Recording
    runner.meta_attention = record_attention
    try:
        reset_launch_counts()
        results_a, losses_a, trainer, secs = run(
            out_a, opts=["DATASETS.BASE_META_SHOTS", str(META_RUN_SHOTS)])
        launches = read_launch_counts()
        (att, att_secs), = attention
        bbox = results_a["bbox"]
        for step, m in losses_a.items():
            log(f"[14]   run step {step}: " + ", ".join(f"{k} {v:.4g}" for k, v in m.items()))
        log(f"[14] Trainer run: {META_RUN_STEPS} steps, a checkpoint at {META_RUN_STEPS // 2} "
            f"and the final evaluation in {secs:.1f} s (the support precompute, "
            f"{META_RUN_SHOTS} shots a class, {att_secs:.1f} s of it); AP "
            f"{bbox['AP']:.4g}, AP50 {bbox['AP50']:.4g}; prototypes "
            f"{list(att.mean.shape)} with {int(torch.isfinite(att.logdet).sum())} finite "
            f"slots; data wait a step, median "
            f"{1e3 * np.median([m['data_time'] for m in trainer.metrics_history]):.2f} ms; "
            f"launches {launches}")
        if not (trainer.meta_iter is not None and sorted(losses_a)
                == list(range(1, META_RUN_STEPS + 1))
                and all(np.isfinite(v) for m in losses_a.values() for v in m.values())
                and all({"loss_rank_margin", "loss_rank_reg", "loss_rank_cls"} <= set(m)
                        for m in losses_a.values())
                and all(np.isfinite(bbox[k]) for k in ("AP", "AP50"))
                and att.mean.shape == (mc.num_classes + 1, 8 * mc.res2_out_channels)
                and int(torch.isfinite(att.logdet).sum()) == len(mc.base_ids) + 1
                and os.path.exists(os.path.join(out_a, f"step_{META_RUN_STEPS // 2}.pt"))):
            raise AssertionError("the Trainer run left out a stream, a step, a checkpoint, "
                                 "the prototypes or a finite loss or AP")
        # K1: the meta steps' 3 each and the evaluation's shots and requests
        by_path["meta_run"] = launches
        del trainer

        # the resume from the checkpoint half way; its evaluation binds
        # prototypes of 5 shots a class, which inference does not read
        os.makedirs(out_b)
        shutil.copy(os.path.join(out_a, f"step_{META_RUN_STEPS // 2}.pt"), out_b)
        results_b, losses_b, trainer, secs = run(
            out_b, "--resume", opts=["DATASETS.BASE_META_SHOTS", "5"])
        del trainer
        same = all(losses_b[s][k] == losses_a[s][k] for s in losses_b for k in losses_b[s])
        rel = max(abs(losses_b[s][k] - losses_a[s][k]) / max(abs(losses_a[s][k]), 1e-12)
                  for s in losses_b for k in losses_b[s])
        log(f"[14] resumed from step {META_RUN_STEPS // 2} in {secs:.1f} s: steps "
            f"{sorted(losses_b)}, losses bit-identical to the uninterrupted run's {same} (max "
            f"rel diff {rel:.3g}, tol {RESUME_LOSS_RTOL}); the evaluation with prototypes of 5 "
            f"shots a class equal to the one with {META_RUN_SHOTS}: "
            f"{results_b['bbox'] == results_a['bbox']}")
        if sorted(losses_b) != list(range(META_RUN_STEPS // 2 + 1, META_RUN_STEPS + 1)) \
                or not rel <= RESUME_LOSS_RTOL:
            raise AssertionError("the resumed Trainer run does not reproduce its steps")
    finally:
        runner.Trainer = real_trainer
        runner.meta_attention = real_attention
        made.clear()
        attention.clear()
        if on_card:
            torch.cuda.empty_cache()
    return by_path, k1_support


def tta_batch(cfg, seed, shape=TTA_IMAGE):
    """(TTA batch, host ms): one seeded image of ``shape`` prepared as
    build_tta_test_loader prepares a record under ``cfg``'s TEST.AUG (the
    canonical image and its resized and flipped variants)."""
    from unit_tpu_torch.data.loader import prepare_tta_batch, tta_variant_configs
    from unit_tpu_torch.data.transforms import TransformConfig

    image = np.random.RandomState(seed).uniform(0, 255, shape + (3,)).astype(np.float32)
    variant_cfgs = tta_variant_configs(cfg, max(shape) / min(shape))
    t0 = time.perf_counter()
    batch = prepare_tta_batch({"image_id": "tta"}, image, TransformConfig.test_from_cfg(cfg),
                              variant_cfgs)
    return batch, (time.perf_counter() - t0) * 1e3


def tta_args(batch, dev):
    """A TTA batch as WSRCNN.predict_tta's arguments on ``dev``."""
    import torch

    def up(x):
        return torch.as_tensor(x).to(dev)

    variants = [{"image": up(v["image"]), "image_size": up(v["image_size"]),
                 "scale": v["scale"], "flip": v["flip"]} for v in batch["variants"]]
    return up(batch["image"]), up(batch["image_size"]), variants


def phase_tta(cfg, seed, workdir):
    """Phase 15: test-time augmentation (TEST.AUG at its defaults: scales
    480-1200, MAX_SIZE 2000, flip) on the flagship at full width, PreciseBN
    and the profile hook, in the directory phase 10 left.  (a) one 600x800
    image: the f32 path with the kernels vs the plain versions; in bf16 its
    launches, time, memory and profile; (b) K1 at the five group shapes and
    K3 at the final NMS, on the inputs of (a); (c) engine.runner.run
    --eval-only with TTA from phase 10's checkpoint on a devkit of
    TTA_EVAL_IMAGES images; (d) precise_bn over 4
    pre-made batches with K4 and with the plain epilogue, then run with
    TEST.PRECISE_BN; (e) run with the profile hook.  Returns ({path: launch
    counts}, K1's numbers at the largest group, K3's at the final NMS)."""
    import glob
    import torch

    from unit_tpu_torch.checkpoint import read_checkpoint
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.evaluation.evaluator import _start_fetch
    from unit_tpu_torch.models.resnet import set_bn_act_impl
    from unit_tpu_torch.ops import nms as nms_ops
    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.utils.precise_bn import precise_bn
    from unit_tpu_torch.utils.profiling import KERNEL_KINDS, kernel_kind

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = cfg.clone()
    cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    cfg.TEST.AUG.ENABLED = True
    batch, _ = tta_batch(cfg, seed + 30)
    n_var = len(batch["variants"])
    groups = len({v["image"].shape for v in batch["variants"]})
    log(f"[15] TEST.AUG: scales {tuple(cfg.TEST.AUG.MIN_SIZES)}, MAX_SIZE "
        f"{cfg.TEST.AUG.MAX_SIZE}, flip {cfg.TEST.AUG.FLIP}: a {TTA_IMAGE[0]}x{TTA_IMAGE[1]} "
        f"image -> canonical {tuple(batch['image'].shape[1:3])} and {n_var} variants in "
        f"{groups} groups: " + ", ".join(
            f"{tuple(v['image'].shape[1:3])}{' flipped' if v['flip'] else ''}"
            for v in batch["variants"]))

    # (a) f32, TF32 off: the path with the kernels vs with the plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model = flagship_model(cfg32, seed, dev)
    args = tta_args(batch, dev)
    outs = {}
    for impl in ("cuda", "plain"):
        model.mc = dataclasses.replace(model.mc, roi_align_impl=impl, nms_impl=impl)
        set_bn_act_impl(model, impl)
        with torch.inference_mode():
            outs[impl] = model.predict_tta_raw(*args)
    (pk, dk, prk), (pp, dp, prp) = outs["cuda"], outs["plain"]
    same_props = torch.equal(prk.valid, prp.valid) and torch.equal(prk.boxes, prp.boxes)
    # probabilities are summed over the variants: their mean is bounded by 1
    dprobs = float((pk - pp).abs().max()) / n_var
    dbbox = float((dk - dp).abs().max()) / max(1.0, float(dp.abs().max()))
    log(f"[15] f32 TTA path: proposals identical {same_props} ({int(prk.valid.sum())} valid); "
        f"summed probs max|diff| / {n_var} variants {dprobs:.3g} (tol {E2E_PROBS_ATOL}); mean "
        f"deltas max|diff|/max {dbbox:.3g} (tol {E2E_BBOX_RTOL})")
    if not (same_props and dprobs <= E2E_PROBS_ATOL and dbbox <= E2E_BBOX_RTOL):
        raise AssertionError("the TTA path with kernels disagrees with the plain path")
    del model, outs, pk, dk, prk, pp, dp, prp
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    if on_card:
        torch.cuda.empty_cache()

    # (a) bf16: launches, time, memory; the K1 and final K3 inputs kept for (b)
    model = flagship_model(cfg, seed, dev)
    n_backbone, n_res5, _ = frozen_bn_counts(model)
    k4_per_image = n_backbone + groups * (n_backbone + 2 * n_res5)
    k1_inputs, k3_inputs = [], []
    real_k1, real_k3 = ra.roi_align_cuda, nms_ops.nms_sorted_mask_cuda

    def record_k1(feats, rois, *a):
        k1_inputs.append((tuple(feats.shape), rois.clone()))
        return real_k1(feats, rois, *a)

    def record_k3(sorted_boxes, thr, cap=None, n_valid=None):
        if cap == model.mc.frcnn.topk_per_image:  # the final NMS, not the RPN's
            k3_inputs.append((sorted_boxes.clone(), thr, cap, n_valid))
        return real_k3(sorted_boxes, thr, cap, n_valid=n_valid)

    def one_image():
        with torch.inference_mode():
            dets = model.predict_tta(*args)
            host, _, event = _start_fetch(dets)  # the evaluator's packed copy
        if event is not None:
            event.synchronize()
        return host

    ra.roi_align_cuda, nms_ops.nms_sorted_mask_cuda = record_k1, record_k3
    try:
        t0 = time.perf_counter()
        host = one_image()  # first call: cuDNN picks the five groups' algorithms
        first = time.perf_counter() - t0
    finally:
        ra.roi_align_cuda, nms_ops.nms_sorted_mask_cuda = real_k1, real_k3
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(TTA_TIMED):
        t0 = time.perf_counter()
        host = one_image()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0
    out = host.numpy()[0]
    valid = out[:, 6] > 0
    boxes, scores = out[valid, :4], out[valid, 4]
    h, w = batch["image_size"][0]
    ok = (np.isfinite(out).all() and valid.any() and (boxes >= 0).all()
          and (boxes[:, 0::2] <= w).all() and (boxes[:, 1::2] <= h).all()
          and (scores > 0).all() and (scores <= n_var).all())
    host_ms = [tta_batch(cfg, seed + 30)[1] for _ in range(3)]
    log(f"[15] bf16 TTA image: first {first:.2f} s, then {[round(v, 2) for v in times]} ms "
        f"(median {np.median(times):.2f}); {int(valid.sum())} detections, scores up to "
        f"{out[valid, 4].max():.4g} (summed over {n_var}); peak device memory {peak:.1f} MiB; "
        f"host preparation ({n_var + 1} numpy resizes) median {np.median(host_ms):.1f} ms; "
        f"launches "
        f"{launches}")
    want = {"roi_align_fwd": groups, "roi_align_bwd": 0, "nms_mask": 2, "nms_mask_images": 2,
            "bn_act_fwd": k4_per_image, "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    if launches != {k: v * TTA_TIMED for k, v in want.items()}:
        raise AssertionError(f"a TTA image did not run K1 x{groups}, K3 x2 and K4 "
                             f"x{k4_per_image}: {launches}")
    if not ok:
        raise AssertionError("the TTA detections are not finite, not in the image or not in "
                             "(0, variants]")
    if on_card:
        profile_run(one_image, "[15]", "TTA image", top=12)

    # (b) K1 at the five group shapes and K3 at the final NMS, on (a)'s inputs
    k1_tta, k3_tta = {}, {}
    if on_card:
        rng = np.random.RandomState(seed + 32)
        worst = 0.0
        largest = max((s for s, _ in k1_inputs), key=lambda s: s[1] * s[2])
        for shape, rois in k1_inputs:  # one launch a group; the canonical pass has none
            feat = torch.as_tensor(rng.randn(*shape).astype(np.float32),
                                   device=dev).to(torch.bfloat16)
            label = f"TTA group {list(shape)} x {rois.shape[1]} ROIs an image"
            worst = max(worst, k1_check(feat, rois, label, tag="[15]"))
            if shape == largest:
                k_ms, p_ms, least = k1_timed(feat, rois, label, tag="[15]")
                q_ms, _ = cuda_ms_queued(lambda: real_k1(feat, rois), 20)
                k1_tta = {"tta_ms": k_ms, "tta_queued_ms": q_ms, "tta_plain_ms": p_ms,
                          "tta_bound_ms": least["bound_ms"], "tta_shape": list(shape)}
        k1_tta["tta_max_abs_err"] = worst
        sb, thr, cap, n_valid = k3_inputs[0]
        got = real_k3(sb, thr, cap, n_valid=n_valid)
        same = torch.equal(got, real_k3(sb, thr, cap, n_valid=n_valid))
        want_mask = nms_ops.nms_sorted_mask_plain(sb, thr, cap)
        keeps = int(got.sum())
        k_ms, _ = cuda_ms_queued(lambda: real_k3(sb, thr, cap, n_valid=n_valid), 20)
        p_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask_plain(sb, thr, cap), 3)
        least = bound(nms_bytes(sb, got, cap, n_valid),
                      nms_pair_tests(got, cap, n_valid) * IOU_FLOPS)
        walked = sum(nms_rows_walked(got, cap, n_valid))
        log(f"[15] K3 final NMS of the TTA image: {sb.shape[-2]} candidates, "
            f"{int(n_valid.sum())} valid, IoU {thr}, cap {cap}: {keeps} kept, {walked} rows "
            f"walked, {int((got != want_mask).sum())} rows differ from the plain version, two launches "
            f"bit-identical {same}; kernel {k_ms:.4f} ms queued, plain {p_ms:.4f} ms, bound "
            f"{least['bound_ms']:.5f} ms by {least['bound_by']}")
        if not (torch.equal(got, want_mask) and same and keeps <= cap):
            raise AssertionError("K3 at the TTA final NMS differs from its plain version")
        k3_tta = {"tta_final_ms": k_ms, "tta_final_plain_ms": p_ms,
                  "tta_final_bound_ms": least["bound_ms"], "tta_final_candidates": sb.shape[-2],
                  "tta_final_valid": int(n_valid.sum()), "tta_final_rows_walked": walked}
    del model, args, k1_inputs[:], k3_inputs[:]
    if on_card:
        torch.cuda.empty_cache()

    # (c) engine.runner.run --eval-only with TTA from phase 10's checkpoint,
    # on a devkit of TTA_EVAL_IMAGES test images (each costs ~2 s of host resizes)
    devkit = write_devkit(os.path.join(workdir, "VOCdevkit_tta"), seed,
                          n_images=TTA_EVAL_IMAGES)
    waits = []
    real_loader = runner.build_tta_test_loader

    class Waited:
        """The TTA loader, with the time each next() waits for the prefetch thread."""

        def __init__(self, loader):
            self.loader = loader

        def __iter__(self):
            return self

        def __next__(self):
            t = time.perf_counter()
            item = next(self.loader)
            waits.append(time.perf_counter() - t)
            return item

        def close(self):
            self.loader.close()

    def timed_loader(*a, **kw):
        loader, n = real_loader(*a, **kw)
        return Waited(loader), n

    def run(out, *flags, opts=()):
        DatasetCatalog.clear()
        args = runner.default_argument_parser().parse_args([
            "--config-file", str(FLAGSHIP), "--data-root", devkit, "--device", RUN_DEVICE,
            *flags, "OUTPUT_DIR", out,
            "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
            "DATASETS.CLASSIFIER_DATAROOT", devkit, "SEED", str(seed),
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
            "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm", *RUN_EXTRA_OPTS, *opts])
        t = time.perf_counter()
        results = runner.run(args, image_loader=seeded_image_loader)
        sync()
        return results, time.perf_counter() - t

    by_path = {}
    runner.build_tta_test_loader = timed_loader
    try:
        reset_launch_counts()
        results, secs = run(os.path.join(workdir, "tta_eval"), "--eval-only",
                            opts=["MODEL.WEIGHTS", os.path.join(workdir, "run_a", "best", "model"),
                                  "TEST.AUG.ENABLED", "True"])
        by_path["tta"] = launches = read_launch_counts()
    finally:
        runner.build_tta_test_loader = real_loader
    per_image = results["inference_seconds_per_image"]
    wait = float(np.mean(waits[1:])) if len(waits) > 1 else float("nan")
    log(f"[15] run --eval-only with TTA over {TTA_EVAL_IMAGES} images in {secs:.1f} s: AP50 "
        f"{results['bbox']['AP50']:.4g}; {per_image:.4f} s per evaluated image (host clock, "
        f"after one warm-up image), of which waiting for the loader {wait:.4f} s (mean of "
        f"{len(waits) - 1}; first image {waits[0]:.3f} s) and the device's forward the rest; "
        f"launches {launches}")
    want = {"roi_align_fwd": groups, "roi_align_bwd": 0, "nms_mask": 2, "nms_mask_images": 2,
            "bn_act_fwd": k4_per_image, "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    if not (np.isfinite(results["bbox"]["AP50"]) and np.isfinite(per_image)
            and launches == {k: v * TTA_EVAL_IMAGES for k, v in want.items()}):
        raise AssertionError(f"the TTA evaluation is not finite or did not run K1 x{groups}, "
                             f"K3 x2 and K4 x{k4_per_image} an image: {launches}")

    # (d) precise_bn over 4 pre-made batches, with K4 and with the plain epilogue
    model = flagship_model(cfg, seed, dev)
    strong, _ = synthetic_train_batches(cfg, seed + 31)
    images = [{"image": torch.as_tensor(b["image"], device=dev)} for b in strong]
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def is_stat(name):
        return name.endswith(".mean") or name.endswith(".var")

    refreshed = {}
    for impl in ("cuda", "cuda", "plain"):  # the first run warms cuDNN up
        model.load_state_dict(start)
        set_bn_act_impl(model, impl)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        precise_bn(model, iter(images), len(images))
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / len(images)
        counts = read_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0
        refreshed[impl] = {k: v.clone() for k, v in model.state_dict().items() if is_stat(k)}
        log(f"[15] precise_bn over {len(images)} batches of {list(images[0]['image'].shape)}, "
            f"bn_act {impl}: {ms:.2f} ms a batch, peak device memory {peak:.1f} MiB, launches "
            f"{counts}")
        if impl == "cuda" and counts != {**{k: 0 for k in counts},
                                         "bn_act_fwd": n_backbone * len(images)}:
            raise AssertionError(f"precise_bn did not run K4 x{n_backbone} a batch alone")
    same = all(torch.equal(refreshed["cuda"][k], refreshed["plain"][k]) for k in refreshed["cuda"])
    moved = [k for k in refreshed["cuda"] if k.startswith("backbone.")
             and not torch.equal(refreshed["cuda"][k], start[k])]
    kept = all(torch.equal(v, start[k]) for k, v in model.state_dict().items()
               if not (is_stat(k) and k.startswith("backbone.")))
    log(f"[15] refreshed statistics with K4 and with the plain epilogue bit-identical {same}; "
        f"{len(moved)} backbone buffers moved, every other tensor unchanged {kept}")
    if not (same and kept and len(moved) == 2 * n_backbone):
        raise AssertionError("precise_bn differs between K4 and the plain epilogue, or moved "
                             "the wrong tensors")
    del model, images, start, refreshed
    if on_card:
        torch.cuda.empty_cache()

    # (d) run with TEST.PRECISE_BN: NUM_ITER cut from 200 to PRECISE_BN_ITERS
    captured = []
    real_precise_bn = runner.precise_bn

    def recording(model, loader, num_iter):
        out = real_precise_bn(model, loader, num_iter)
        captured.append({k: v.clone() for k, v in model.state_dict().items() if is_stat(k)})
        return out

    init = glob.glob(os.path.join(workdir, "init", "step_*.pt"))[0]
    out_bn = os.path.join(workdir, "precise_bn")
    runner.precise_bn = recording
    try:
        results, secs = run(out_bn, opts=[
            "MODEL.WEIGHTS", init, "SOLVER.MAX_ITER", str(PRECISE_BN_PERIOD),
            "SOLVER.CHECKPOINT_PERIOD", str(PRECISE_BN_PERIOD),
            "TEST.EVAL_PERIOD", str(PRECISE_BN_PERIOD), "TEST.PRECISE_BN.ENABLED", "True",
            "TEST.PRECISE_BN.NUM_ITER", str(PRECISE_BN_ITERS)])
    finally:
        runner.precise_bn = real_precise_bn
    saved = read_checkpoint(os.path.join(out_bn, f"step_{PRECISE_BN_PERIOD}.pt"))["model"]
    first = read_checkpoint(init)["model"]
    ok = (len(captured) == 1
          and all(torch.equal(saved[k], v.cpu()) for k, v in captured[0].items())
          and all(not torch.equal(saved[k], first[k]) for k in captured[0]
                  if k.startswith("backbone.")))
    log(f"[15] run with TEST.PRECISE_BN (NUM_ITER {PRECISE_BN_ITERS}, EVAL_PERIOD "
        f"{PRECISE_BN_PERIOD}) in {secs:.1f} s: {len(captured)} refresh, the step-"
        f"{PRECISE_BN_PERIOD} checkpoint holds the refreshed statistics {ok}; AP50 "
        f"{results['bbox']['AP50']:.4g}")
    if not ok:
        raise AssertionError("the step's checkpoint does not hold the refreshed statistics")

    # (e) run with the profile hook: the trace of steps 3 and 4
    out_prof = os.path.join(workdir, "profiled")
    results, secs = run(out_prof, opts=[
        "MODEL.WEIGHTS", init, "SOLVER.MAX_ITER", "4", "SOLVER.CHECKPOINT_PERIOD", "0",
        "TEST.EVAL_PERIOD", "0", "TPU.PROFILE_START_STEP", "2", "TPU.PROFILE_NUM_STEPS", "2"])
    traces = glob.glob(os.path.join(out_prof, "trace", "*.pt.trace.json"))
    names = set()
    for path in traces:
        with open(path) as f:
            names |= {str(e.get("name", "")) for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel"}
    found = {kind: sorted(n for n in names if kernel_kind(n) == kind)[:1]
             for kind, _ in KERNEL_KINDS[:4]}
    log(f"[15] run with TPU.PROFILE_START_STEP 2, PROFILE_NUM_STEPS 2 in {secs:.1f} s: "
        f"{len(traces)} trace ({sum(os.path.getsize(p) for p in traces) / 2**20:.1f} MiB), "
        f"{len(names)} kernel names; " + ", ".join(f"{k}: {v}" for k, v in found.items()))
    if len(traces) != 1 or (on_card and not all(found.values())):
        raise AssertionError("the profile hook wrote no trace, or one without K1-K4")
    return by_path, k1_tta, k3_tta


def phase_note(seed, workdir):
    """Phase 16: the note recipe (COCO-RCNN-50-C4-split1-note.yaml) at full
    width and depth: InceptionResNetV2 to block17, the InceptionResNetV2 tail
    as the box head over 17x17 ROIs, 80 classes, seeded weights, GloVe, bf16.
    (a) served requests; (b) the f32 predict path, kernels vs plain; (c)
    TrainerNoMeta steps of 2 + 2 images in both orientations, then one step
    at the recipe's IMS_PER_BATCH (its strong and weak loaders read 8 images
    each); (d) the f32 train path, kernels vs plain; (e) K1 and K2 against
    their plain versions at (c)'s own inputs (P = 17, C = 1088) and K3 at its
    RPN's; (f) engine.runner.run on the shapes-COCO devkit of phase 12: 4
    steps, a checkpoint and an evaluation at 2, a resume from 2.  Returns
    ({path: launch counts}, K1's, K2's and K3's numbers at the note shapes)."""
    import runpy

    import torch

    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import TrainerNoMeta
    from unit_tpu_torch.models.similarity import COCO_CLASSES
    from unit_tpu_torch.ops import nms as nms_ops
    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.serving import DetectionService
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_mib():
        return torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def free():
        if on_card:
            torch.cuda.empty_cache()

    cfg = get_cfg()
    cfg.merge_from_file(str(NOTE_RECIPE))
    cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    by_path = {}
    p = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION

    # (a) served requests
    t0 = time.perf_counter()
    model = flagship_model(cfg, seed, dev)  # no FrozenBN: nothing to calibrate
    mc = model.mc
    n_bn = frozen_bn_counts(model)
    log(f"[16] {NOTE_RECIPE.relative_to(ROOT)}: {type(model.backbone).__name__} + "
        f"{type(model.box_head).__name__} built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(q.numel() for q in model.parameters()) / 1e6:.1f} M params (backbone "
        f"{sum(q.numel() for q in model.backbone.parameters()) / 1e6:.1f} M, box head "
        f"{sum(q.numel() for q in model.box_head.parameters()) / 1e6:.1f} M), "
        f"{model.backbone.out_channels} channels into the RPN (conv {mc.rpn_conv_dim}) and "
        f"the pooler, {mc.pooler_resolution}x{mc.pooler_resolution} ROIs, head "
        f"{model.box_head.out_channels}-d, {mc.num_classes} classes, {mc.roi_batch_size} ROIs a "
        f"strong image, compute {mc.compute_dtype}; FrozenBN modules (backbone, box head, "
        f"trainable) {n_bn}")
    if n_bn != (0, 0, 0):
        raise AssertionError(f"the note model holds FrozenBN modules: {n_bn}")
    svc = DetectionService(cfg, model, class_names=COCO_CLASSES)
    t0 = time.perf_counter()
    svc.warmup()
    sync()
    log(f"[16] warm-up, one request per orientation: {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(seed + 160)
    images = [rng.uniform(0, 255, NOTE_REQUEST_SHAPES[i % 2] + (3,)).astype(np.float32)
              for i in range(NOTE_REQUESTS)]
    reset_peak()
    reset_launch_counts()
    lat, results = [], []
    for img in images:
        t0 = time.perf_counter()
        results.append(svc.detect_array(img))  # ends in a device-to-host copy
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = read_launch_counts()
    log(f"[16] {NOTE_REQUESTS} requests, latency ms {[round(v, 2) for v in lat]}, median "
        f"{np.median(lat):.2f}, peak device memory {peak_mib():.1f} MiB; detections per "
        f"request {[len(r) for r in results]}; launches {launches}")
    want = {"roi_align_fwd": NOTE_REQUESTS, "roi_align_bwd": 0, "nms_mask": 2 * NOTE_REQUESTS,
            "nms_mask_images": 2 * NOTE_REQUESTS, "bn_act_fwd": 0, "bn_act_bwd": 0,
            "bn_act_layout_copies": 0}
    if launches != want:
        raise AssertionError(f"a note request did not run K1 x1, K3 x2 and no K4: {launches}")
    by_path["note_serving"] = launches
    for img, dets in zip(images, results):
        h, w = img.shape[:2]
        for d in dets:
            x1, y1, x2, y2 = d["box"]
            if not (np.isfinite(d["box"]).all() and 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
                    and 0 < d["score"] <= 1 and 0 <= d["class_id"] < mc.num_classes):
                raise AssertionError(f"a detection outside the image or range: {d}")
    # the map, the proposals kept at random weights and K1 at a request's input
    k1_request = {}
    for i, shape in enumerate(NOTE_REQUEST_SHAPES):
        s = prepare_test_image(images[i], svc.tcfg)
        with torch.inference_mode():
            probs, bbox, props, feats = model.predict_raw(
                torch.as_tensor(s["image"][None], device=dev),
                torch.as_tensor(s["image_size"][None], device=dev))
        n_prop = int(props.valid.sum())
        finite = bool(torch.isfinite(probs).all() and torch.isfinite(bbox).all()
                      and torch.isfinite(feats.float()).all())
        ch, cw = s["image"].shape[:2]
        log(f"[16] {shape} -> canvas {(ch, cw)}: block17 map {tuple(feats.shape)} "
            f"{feats.dtype} (ceil(H/16) x ceil(W/16) would be {-(-ch // 16)}x{-(-cw // 16)}), "
            f"{n_prop} of {props.valid.shape[1]} proposals kept, probs {tuple(probs.shape)}, "
            f"finite {finite}")
        if n_prop <= 0 or not finite:
            raise AssertionError("no proposals or non-finite raw outputs on the note path")
        if on_card and i == 0:
            rois = props.boxes.float().contiguous()
            label = f"note request {list(feats.shape)} x {rois.shape[1]} ROIs P={p}"
            err = k1_check(feats, rois, label, tag="[16]", p=p)
            k_ms, p_ms, least = k1_timed(feats, rois, label, tag="[16]", p=p)
            q_ms, _ = cuda_ms_queued(lambda: ra.roi_align_cuda(feats, rois, p), 20)
            k1_request = {"note_request_ms": k_ms, "note_request_queued_ms": q_ms,
                          "note_request_plain_ms": p_ms,
                          "note_request_bound_ms": least["bound_ms"],
                          "note_request_max_abs_err": err,
                          "note_request_shape": list(feats.shape) + [rois.shape[1], p]}
    if on_card:
        profile_run(lambda: svc.detect_array(images[0]), "[16]", "note request", top=12)
    del svc, model, feats, props, probs, bbox
    free()

    # (b) the f32 predict path, kernels vs plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = flagship_model(cfg32, seed, dev)
    s = prepare_test_image(images[1], TransformConfig.test_from_cfg(cfg32))
    img = torch.as_tensor(s["image"][None], device=dev)
    size = torch.as_tensor(s["image_size"][None], device=dev)
    outs = {}
    for impl in ("cuda", "plain"):
        model32.mc = dataclasses.replace(model32.mc, roi_align_impl=impl, nms_impl=impl)
        with torch.inference_mode():
            outs[impl] = model32.predict_raw(img, size)[:3]
    (pk, bk, prk), (pp, bp, prp) = outs["cuda"], outs["plain"]
    same_props = torch.equal(prk.valid, prp.valid) and torch.equal(prk.boxes, prp.boxes)
    dprobs = float((pk - pp).abs().max())
    dbbox = float((bk - bp).abs().max()) / max(1.0, float(bp.abs().max()))
    log(f"[16] f32, TF32 off, predict_raw: proposals identical {same_props} "
        f"({int(prk.valid.sum())} valid); probs max|diff| {dprobs:.3g} (tol {E2E_PROBS_ATOL}); "
        f"bbox max|diff|/max|bbox| {dbbox:.3g} (tol {E2E_BBOX_RTOL})")
    if not (same_props and dprobs <= E2E_PROBS_ATOL and dbbox <= E2E_BBOX_RTOL):
        raise AssertionError("the note predict path with kernels disagrees with the plain path")
    del model32, outs, pk, bk, prk, pp, bp, prp
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    free()

    # (c) train steps: 2 strong + 2 weak images, both orientations, clipped as
    # phase 7; the first warm-up step's K1, K2 and K3 inputs are kept for (e)
    cfg_t = cfg.clone()
    cfg_t.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg_t.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    model = flagship_model(cfg_t, seed, dev)
    solver = build_optimizer(cfg_t, model)
    n_trainable = sum(q.numel() for q in model.parameters() if q.requires_grad)
    strong, weak = synthetic_train_batches(cfg_t, seed + 16, canvases=NOTE_CANVASES)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()

    def step(tr, label):
        t = time.perf_counter()
        m = tr.run_step().resolve()  # read now: the clock holds the device's time
        ms = (time.perf_counter() - t) * 1e3
        log(f"[16] step {tr.state.step} ({label}) {ms:.1f} ms: "
            + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
        return ms

    k1_in, k2_in, k3_in = [], [], []
    real = (ra.roi_align_cuda, ra.roi_align_backward_cuda, nms_ops.nms_sorted_mask_cuda)

    def record_k1(feats, rois, *a):
        k1_in.append((feats.detach().clone(), rois.clone()))
        return real[0](feats, rois, *a)

    def record_k2(g, rois, shape, *a):
        k2_in.append((g.clone(), rois.clone(), tuple(shape)))
        return real[1](g, rois, shape, *a)

    def record_k3(boxes, thr, cap=None, n_valid=None):
        k3_in.append((boxes.clone(), thr, cap, None if n_valid is None else n_valid.clone()))
        return real[2](boxes, thr, cap, n_valid=n_valid)

    if on_card:
        ra.roi_align_cuda, ra.roi_align_backward_cuda = record_k1, record_k2
        nms_ops.nms_sorted_mask_cuda = record_k3
    try:
        step(trainer, "warm-up, the kernels' inputs kept")
    finally:
        ra.roi_align_cuda, ra.roi_align_backward_cuda, nms_ops.nms_sorted_mask_cuda = real
    for _ in range(TRAIN_WARMUP - 1):
        step(trainer, "warm-up")
    sync()
    reset_peak()
    reset_launch_counts()
    times = [step(trainer, "timed") for _ in range(NOTE_TRAIN_STEPS)]
    launches = read_launch_counts()
    med = float(np.median(times))
    imgs = 2 * strong[0]["image"].shape[0]
    per_step = {k: v / NOTE_TRAIN_STEPS for k, v in launches.items()}
    log(f"[16] {NOTE_TRAIN_STEPS} timed note train steps ({n_trainable / 1e6:.1f} M trainable "
        f"params, every backbone tensor among them): median {med:.2f} ms (min "
        f"{min(times):.2f}, max {max(times):.2f}), {1e3 * imgs / med:.2f} images/s ({imgs} per "
        f"step), peak device memory {peak_mib():.1f} MiB; launches a step {per_step} (want K1 "
        f"2, K2 2, K3 1 for 4 images, no K4)")
    want = {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1, "nms_mask_images": 4,
            "bn_act_fwd": 0, "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    if per_step != want:
        raise AssertionError(f"a note train step's launches: {per_step}")
    by_path["note"] = launches
    if not all(np.isfinite(v) for m in trainer.metrics_history for v in m.values()):
        raise AssertionError("a note train step without finite losses")
    if on_card:
        profile_run(trainer.run_step, "[16]", "note train step", top=15)
    del trainer, strong, weak
    free()

    # the recipe's IMS_PER_BATCH: the strong and the weak loader read that
    # many images each a step
    per_stream = cfg_t.SOLVER.IMS_PER_BATCH
    strong, weak = synthetic_train_batches(cfg_t, seed + 17, n_batches=1,
                                           per_stream=per_stream, canvases=NOTE_CANVASES)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    sync()
    reset_peak()
    reset_launch_counts()
    ms_full = step(trainer, f"{per_stream} + {per_stream} images")
    launches = read_launch_counts()
    peak_full = peak_mib()
    log(f"[16] one step at IMS_PER_BATCH {per_stream} ({per_stream} strong + {per_stream} weak "
        f"images, {2 * per_stream * mc.roi_batch_size} ROIs through the head): {ms_full:.1f} ms "
        f"(the first at this shape), {1e3 * 2 * per_stream / ms_full:.2f} images/s, peak device "
        f"memory {peak_full:.1f} MiB; launches {launches}")
    want_full = {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1,
                 "nms_mask_images": 2 * per_stream, "bn_act_fwd": 0, "bn_act_bwd": 0,
                 "bn_act_layout_copies": 0}
    if launches != want_full or not all(np.isfinite(v) for v in
                                         trainer.metrics_history[-1].values()):
        raise AssertionError(f"the {per_stream}-image note step: {launches}, "
                             f"{trainer.metrics_history[-1]}")
    by_path["note_full_batch"] = launches
    del trainer, solver, model, strong, weak
    free()

    # (d) the f32 train path, kernels vs plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model32 = flagship_model(cfg32, seed, dev)
    build_optimizer(cfg32, model32)
    strong, weak = synthetic_train_batches(cfg32, seed + 18, n_batches=1,
                                           canvases=NOTE_CANVASES)
    strong = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    weak = {k: torch.as_tensor(v, device=dev) for k, v in weak[0].items()}
    train_path_kernels_vs_plain(model32, strong, weak, seed, "[16]")
    del model32, strong, weak
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    free()

    # (e) K1, K2 and K3 at (c)'s own inputs: the step's strong and weak ROIs
    # on its block17 map (P = 17, C = 1088), the gradients its heads sent back
    # and its RPN's proposals
    k1_note, k2_note, k3_note = {}, {}, {}
    if on_card:
        worst = 0.0
        for i, (feats, rois) in enumerate(k1_in):
            stream = ("strong", "weak")[i]
            label = f"note train step, {stream} {list(feats.shape)} x {rois.shape[1]} ROIs P={p}"
            worst = max(worst, k1_check(feats, rois, label, tag="[16]", p=p))
            if i == 0:
                k_ms, p_ms, least = k1_timed(feats, rois, label, tag="[16]", p=p)
                q_ms, _ = cuda_ms_queued(lambda: real[0](feats, rois, p), 20)
                k1_note = {"note_train_ms": k_ms, "note_train_queued_ms": q_ms,
                           "note_train_plain_ms": p_ms, "note_train_bound_ms": least["bound_ms"],
                           "note_train_shape": list(feats.shape) + [rois.shape[1], p]}
        k1_note["note_train_max_abs_err"] = worst
        worst = 0.0
        for i, (g, rois, shape) in enumerate(k2_in):
            label = f"note train step g {list(g.shape)} onto {list(shape)}"
            k2_check(g.float(), rois, shape, p, label + " f32", tag="[16]")
            worst = max(worst, k2_check(g, rois, shape, p, label + " bf16", tag="[16]"))
            if i == 0:
                k_ms, p_ms, q_ms = k2_timed(g, rois, shape, label, tag="[16]", p=p)
                out_bytes = int(np.prod(shape)) * g.element_size()
                least = bound(nbytes(g, rois) + out_bytes, g.numel() * ROI_ALIGN_FLOPS)
                log(f"[16] K2 {label}: bound {least['bound_ms']:.4f} ms by {least['bound_by']}")
                k2_note = {"note_train_ms": k_ms, "note_train_queued_ms": q_ms,
                           "note_train_plain_ms": p_ms, "note_train_bound_ms": least["bound_ms"],
                           "note_train_shape": list(g.shape)}
        k2_note["note_train_max_abs_err"] = worst
        (sb, thr, cap, n_valid), = k3_in  # one selection for the step's 4 images
        got = real[2](sb, thr, cap, n_valid=n_valid)
        same = torch.equal(got, real[2](sb, thr, cap, n_valid=n_valid))
        plain = nms_ops.nms_sorted_mask_plain(sb, thr, cap)
        k_ms, _ = cuda_ms_queued(lambda: real[2](sb, thr, cap, n_valid=n_valid), 20)
        p_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask_plain(sb, thr, cap), 2)
        least = bound(nms_bytes(sb, got, cap, n_valid),
                      nms_pair_tests(got, cap, n_valid) * IOU_FLOPS)
        log(f"[16] K3 note train step's RPN: {list(sb.shape)} -> {cap} at IoU {thr}, keeps "
            f"{got.sum(-1).tolist()}, {int((got != plain).sum())} rows differ from the plain "
            f"version, two launches bit-identical {same}; kernel {k_ms:.4f} ms queued, plain "
            f"{p_ms:.4f} ms, bound {least['bound_ms']:.5f} ms by {least['bound_by']}")
        if not (torch.equal(got, plain) and same):
            raise AssertionError("K3 at the note train step's RPN input differs from its plain "
                                 "version")
        k3_note = {"note_train_ms": k_ms, "note_train_plain_ms": p_ms,
                   "note_train_bound_ms": least["bound_ms"],
                   "note_train_keeps": got.sum(-1).tolist()}
    del k1_in[:], k2_in[:], k3_in[:]
    free()

    # (f) the run loop on phase 12's shapes-COCO devkit: 4 steps, a
    # checkpoint and an evaluation at 2, then a resume from the checkpoint
    root = os.path.join(workdir, "shapes_coco")
    if not os.path.isdir(root):
        runpy.run_path(str(ROOT / "scripts" / "make_shapes_coco_torch.py"))[
            "write_shapes_coco"](root, COCO_TRAIN_IMAGES, COCO_VAL_IMAGES, COCO_IMAGE_SIZE, seed)
    made = []

    class Recording(TrainerNoMeta):
        """The runner's trainer, kept so that the script can read its losses."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def run(out, *flags):
        DatasetCatalog.clear()
        made.clear()
        args = runner.default_argument_parser().parse_args([
            "--config-file", str(NOTE_RECIPE), "--data-root", root, "--device", RUN_DEVICE,
            *flags, "OUTPUT_DIR", out,
            "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
            "DATASETS.CLASSIFIER_DATAROOT", root, "SEED", str(seed),
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(NOTE_RUN_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(NOTE_RUN_STEPS // 2),
            "TEST.EVAL_PERIOD", str(NOTE_RUN_STEPS // 2),
            "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
            *RUN_EXTRA_OPTS])
        t = time.perf_counter()
        results = runner.run(args)
        sync()
        trainer = made[-1]
        first = trainer.state.step - len(trainer.metrics_history)
        losses = {first + 1 + k: {n: v for n, v in m.items() if n != "data_time"}
                  for k, m in enumerate(trainer.metrics_history)}
        return results, losses, time.perf_counter() - t

    out_a, out_b = os.path.join(workdir, "note_run_a"), os.path.join(workdir, "note_run_b")
    real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
    try:
        reset_launch_counts()
        results_a, losses_a, secs = run(out_a)
        launches = read_launch_counts()
        bbox = {k: results_a["bbox"][k] for k in ("AP", "AP50", "AP75", "novel_mean")}
        for k, m in losses_a.items():
            log(f"[16]   run step {k}: " + ", ".join(f"{n} {v:.4g}" for n, v in m.items()))
        log(f"[16] run: {len(losses_a)} steps with a checkpoint and an evaluation every "
            f"{NOTE_RUN_STEPS // 2} in {secs:.1f} s; bbox " + ", ".join(
                f"{k} {v:.4g}" for k, v in bbox.items()) + f"; launches {launches}")
        if not (sorted(losses_a) == list(range(1, NOTE_RUN_STEPS + 1))
                and all(np.isfinite(v) for m in losses_a.values() for v in m.values())
                and all(np.isfinite(v) for v in bbox.values())
                and os.path.exists(os.path.join(out_a, f"step_{NOTE_RUN_STEPS // 2}.pt"))):
            raise AssertionError("the note run left out a step, a checkpoint or a finite loss "
                                 "or AP")
        by_path["note_run"] = launches
        os.makedirs(out_b)
        shutil.copy(os.path.join(out_a, f"step_{NOTE_RUN_STEPS // 2}.pt"), out_b)
        _, losses_b, secs = run(out_b, "--resume")
        rel = max(abs(losses_b[k][n] - losses_a[k][n]) / max(abs(losses_a[k][n]), 1e-12)
                  for k in losses_b for n in losses_b[k])
        same = all(losses_b[k][n] == losses_a[k][n] for k in losses_b for n in losses_b[k])
        log(f"[16] resumed from step {NOTE_RUN_STEPS // 2} in {secs:.1f} s: steps "
            f"{sorted(losses_b)}, losses bit-identical to the uninterrupted run's {same} (max "
            f"rel diff {rel:.3g}, tol {RESUME_LOSS_RTOL})")
        if sorted(losses_b) != list(range(NOTE_RUN_STEPS // 2 + 1, NOTE_RUN_STEPS + 1)) \
                or not rel <= RESUME_LOSS_RTOL:
            raise AssertionError("the resumed note run does not reproduce its steps")
    finally:
        runner.TrainerNoMeta = real_trainer
        made.clear()
    free()
    log(f"[16] phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return by_path, k1_request | k1_note, k2_note, k3_note


def dock_proposals(writer, rng, gt_boxes, h, w, capacity):
    """One image's entry of a seeded MCG-style proposal file
    (scripts/make_shapes_proposals_torch.py: its GT boxes, jittered copies,
    random boxes) for content h x w, padded as the loaders pad it:
    (boxes [capacity, 4], valid [capacity])."""
    from unit_tpu_torch.data.proposals import pad_record_proposals

    boxes, _ = writer(gt_boxes, w, h, rng, per_image=capacity)
    return pad_record_proposals({"proposals": boxes[:capacity]}, 1.0, capacity,
                                new_w=w, new_h=h)


def with_dock_proposals(writer, rng, strong, weak, capacity, weak_files=True):
    """Precomputed proposals into synthetic batches, as the dock loaders give
    them: the strong images' from their GT boxes, the weak ones' random; with
    ``weak_files`` False the weak slots are all invalid (R12) and the strong
    batch keeps none (the YAML alone: the RPN proposes for it)."""
    for s, w in zip(strong, weak):
        sizes = s["image_size"].astype(int)
        if weak_files:
            s["proposals"], s["proposals_valid"] = (np.stack(x) for x in zip(*(
                dock_proposals(writer, rng, s["gt_boxes"][i][s["gt_valid"][i]], h, wd, capacity)
                for i, (h, wd) in enumerate(sizes))))
            w["proposals"], w["proposals_valid"] = (np.stack(x) for x in zip(*(
                dock_proposals(writer, rng, np.zeros((0, 4)), h, wd, capacity)
                for h, wd in w["image_size"].astype(int))))
        else:
            n = len(w["image"])
            w["proposals"] = np.zeros((n, capacity, 4), np.float32)
            w["proposals_valid"] = np.zeros((n, capacity), bool)
    return strong, weak


def phase_dock(seed, workdir):
    """Phase 17: the dock recipe (COCO-VGG-CNN-F-split1-dock.yaml) at full
    width: VGG-CNN-F with Caffe LRN, ROIPool at 6x6 into the VGG fc head
    (4096 wide, dropout in training), 80 classes, seeded weights, GloVe,
    bf16, precomputed (MCG-style) proposals.  (a) requests with a proposal
    file (PRECOMPUTED_PROPOSAL_TOPK_TEST a request) through make_predict_fn;
    (b) the f32 predict path, kernels vs plain: identical detections; (c)
    TrainerNoMeta steps of 2 + 2 images in both orientations at the largest
    train size with proposals for both streams (no kernel runs), then one at
    the recipe's IMS_PER_BATCH; (d) the YAML alone: the RPN over VGG-CNN-F
    with R12's empty weak slots, its steps, its requests and its f32 train
    path kernels vs plain; (e) ROIPool forward and backward at (c)'s own
    inputs, as a layer of the step; (f) engine.runner.run on phase 12's
    shapes-COCO devkit with proposal pickles: 4 steps, a checkpoint and an
    evaluation at 2, a resume; (g) one image under TEST.AUG.ENABLED with
    proposals.  Returns ({path: launch counts}, K3's numbers at a dock
    request's final NMS)."""
    import runpy

    import torch

    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.loader import prepare_tta_batch, tta_variant_configs
    from unit_tpu_torch.data.proposals import attach_proposals
    from unit_tpu_torch.data.transforms import (TransformConfig, max_aspect_of,
                                                prepare_detection_record)
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.predict import make_predict_fn, make_tta_predict_fn
    from unit_tpu_torch.engine.train import TrainerNoMeta
    from unit_tpu_torch.models import meta_arch
    from unit_tpu_torch.models.similarity import COCO_CLASSES
    from unit_tpu_torch.ops import nms as nms_ops
    from unit_tpu_torch.ops.roi_pool import roi_pool_max
    from unit_tpu_torch.serving import DetectionService
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    writer = runpy.run_path(str(ROOT / "scripts" / "make_shapes_proposals_torch.py"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_mib():
        return torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def free():
        if on_card:
            torch.cuda.empty_cache()

    cfg = get_cfg()
    cfg.merge_from_file(str(DOCK_RECIPE))
    cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    by_path = {}
    none = {"roi_align_fwd": 0, "roi_align_bwd": 0, "nms_mask": 0, "nms_mask_images": 0,
            "bn_act_fwd": 0, "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    topk_test = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
    topk_train = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN
    rng = np.random.RandomState(seed + 170)

    # (a) requests with a proposal file, as the evaluation's predict takes
    # them: the file's top-K a request, scaled and clipped by the test loader's
    # record preparation
    t0 = time.perf_counter()
    model = flagship_model(cfg, seed, dev)  # no FrozenBN: nothing to calibrate
    mc = model.mc
    n_bn = frozen_bn_counts(model)
    log(f"[17] {DOCK_RECIPE.relative_to(ROOT)}: {type(model.backbone).__name__} + "
        f"{type(model.box_head).__name__} built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(q.numel() for q in model.parameters()) / 1e6:.1f} M params (backbone "
        f"{sum(q.numel() for q in model.backbone.parameters()) / 1e6:.1f} M, box head "
        f"{sum(q.numel() for q in model.box_head.parameters()) / 1e6:.1f} M), "
        f"{model.backbone.out_channels} channels, {mc.pooler_type} {mc.pooler_resolution}x"
        f"{mc.pooler_resolution}, head {model.box_head.out_channels}-d, {mc.num_classes} "
        f"classes, {mc.roi_batch_size} ROIs a strong image and {mc.weak_proposal_count} weak "
        f"proposals, {topk_test} proposals a request, compute {mc.compute_dtype}; FrozenBN "
        f"modules {n_bn}")
    if n_bn != (0, 0, 0) or not mc.load_proposals:
        raise AssertionError(f"the dock model holds FrozenBN modules or reads no proposals: "
                             f"{n_bn}, {mc.load_proposals}")
    tcfg = TransformConfig.test_from_cfg(cfg)
    tcfg.proposal_capacity = topk_test
    records, images = [], []
    table = {}
    for i in range(DOCK_REQUESTS):
        h, w = DOCK_REQUEST_SHAPES[i % 2]
        images.append(rng.uniform(0, 255, (h, w, 3)).astype(np.float32))
        gt = rng.uniform(0, 1, (3, 4)) * [w / 2, h / 2, w / 2, h / 2]
        gt[:, 2:] += gt[:, :2] + 16
        boxes, scores = writer["mcg_like_proposals"](gt, w, h, rng, per_image=topk_test)
        table[str(i)] = {"boxes": boxes, "scores": scores}
        records.append({"image_id": str(i), "height": h, "width": w, "annotations": []})
    path = os.path.join(workdir, "dock_requests.pkl")
    with open(path, "wb") as f:
        pickle.dump(table, f)
    attach_proposals(records, [path], topk_test)
    prepared = [prepare_detection_record(r, tcfg, None, image=im, training=False)
                for r, im in zip(records, images)]
    predict = make_predict_fn(model)

    def request(s):
        dets = predict(s["image"][None], s["image_size"][None], s["proposals"][None],
                       s["proposals_valid"][None])
        return [t.cpu() for t in (dets.boxes, dets.scores, dets.classes, dets.valid)]

    for s in prepared[:2]:  # warm-up, one per orientation
        request(s)
    sync()
    reset_peak()
    reset_launch_counts()
    lat, results = [], []
    for s in prepared:
        t0 = time.perf_counter()
        results.append(request(s))  # ends in a device-to-host copy
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = read_launch_counts()
    log(f"[17] {DOCK_REQUESTS} requests of {DOCK_REQUEST_SHAPES} with {topk_test} proposals "
        f"each, latency ms {[round(v, 2) for v in lat]}, median {np.median(lat):.2f}, peak "
        f"device memory {peak_mib():.1f} MiB; detections per request "
        f"{[int(r[3].sum()) for r in results]}; launches {launches}")
    want = dict(none, nms_mask=DOCK_REQUESTS, nms_mask_images=DOCK_REQUESTS)
    if launches != want:
        raise AssertionError(f"a dock request with proposals did not run K3 x1 (the final "
                             f"NMS) and nothing else: {launches}")
    by_path["dock_serving"] = launches
    for s, (boxes, scores, classes, valid) in zip(prepared, results):
        h, w = s["image_size"]
        b, sc, cl = boxes[valid].numpy(), scores[valid].numpy(), classes[valid].numpy()
        if not (np.isfinite(b).all() and (b[:, 0] >= 0).all() and (b[:, 2] <= w).all()
                and (b[:, 1] >= 0).all() and (b[:, 3] <= h).all() and (b[:, 0] <= b[:, 2]).all()
                and ((sc > 0) & (sc <= 1)).all() and (cl < mc.num_classes).all()):
            raise AssertionError("a dock detection outside the image or range")
    # K3 at a request's own final NMS input
    k3_dock = {}
    if on_card:
        real = nms_ops.nms_sorted_mask_cuda
        k3_in = []

        def record_k3(boxes, thr, cap=None, n_valid=None):
            k3_in.append((boxes.clone(), thr, cap, None if n_valid is None else n_valid.clone()))
            return real(boxes, thr, cap, n_valid=n_valid)

        nms_ops.nms_sorted_mask_cuda = record_k3
        try:
            request(prepared[0])
        finally:
            nms_ops.nms_sorted_mask_cuda = real
        (sb, thr, cap, n_valid), = k3_in
        got = real(sb, thr, cap, n_valid=n_valid)
        same = torch.equal(got, real(sb, thr, cap, n_valid=n_valid))
        plain = nms_ops.nms_sorted_mask_plain(sb, thr, cap)
        k_ms, host_ms = cuda_ms_queued(lambda: real(sb, thr, cap, n_valid=n_valid), 20)
        p_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask_plain(sb, thr, cap), 2)
        least = bound(nms_bytes(sb, got, cap, n_valid),
                      nms_pair_tests(got, cap, n_valid) * IOU_FLOPS)
        log(f"[17] K3 at a dock request's final NMS: {list(sb.shape)} -> {cap} at IoU {thr}, "
            f"keeps {got.sum(-1).tolist()}, {int((got != plain).sum())} rows differ from the "
            f"plain version, two launches bit-identical {same}; kernel {k_ms:.4f} ms queued "
            f"(host {host_ms:.4f} ms a call), plain {p_ms:.4f} ms, bound "
            f"{least['bound_ms']:.5f} ms by {least['bound_by']}")
        if not (torch.equal(got, plain) and same):
            raise AssertionError("K3 at the dock request's final NMS differs from its plain "
                                 "version")
        k3_dock = {"dock_request_ms": k_ms, "dock_request_plain_ms": p_ms,
                   "dock_request_bound_ms": least["bound_ms"],
                   "dock_request_shape": list(sb.shape) + [cap]}
        profile_run(lambda: request(prepared[0]), "[17]", "dock request", top=12)
    del model, predict, results
    free()

    # (b) the f32 predict path with proposals, kernels vs plain: K3 is exact
    # and nothing else differs, so the detections are identical
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = flagship_model(cfg32, seed, dev)
    s = prepared[1]
    args = [torch.as_tensor(s[k][None], device=dev)
            for k in ("image", "image_size", "proposals", "proposals_valid")]
    outs = {}
    for impl in ("cuda", "plain"):
        model32.mc = dataclasses.replace(model32.mc, roi_align_impl=impl, nms_impl=impl)
        with torch.inference_mode():
            d = model32.predict(*args)
        outs[impl] = (d.boxes, d.scores, d.classes, d.valid)
    same = all(torch.equal(a, b) for a, b in zip(outs["cuda"], outs["plain"]))
    log(f"[17] f32, TF32 off, predict with {topk_test} proposals: detections identical "
        f"{same} ({int(outs['cuda'][3].sum())} valid)")
    if not same:
        raise AssertionError("the dock predict path with kernels disagrees with the plain path")
    del model32, outs
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    free()

    # (c) train steps at the largest train size (the YAML's 1200-pixel short
    # side in its MAX_SIZE_TRAIN canvas), both orientations, proposals for
    # both streams: no RPN, so no kernel; the first warm-up step's ROIPool
    # inputs are kept for (e)
    cfg_t = cfg.clone()
    cfg_t.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg_t.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    canvas = TransformConfig.train_from_cfg(cfg_t).canvas
    short = max(cfg_t.INPUT.MIN_SIZE_TRAIN)
    content = (short, min(int(round(short * 4 / 3)), cfg_t.INPUT.MAX_SIZE_TRAIN))
    canvases = ((canvas, content), (canvas[::-1], content[::-1]))
    model = flagship_model(cfg_t, seed, dev)
    solver = build_optimizer(cfg_t, model)
    n_trainable = sum(q.numel() for q in model.parameters() if q.requires_grad)
    strong, weak = with_dock_proposals(writer["mcg_like_proposals"], rng,
                                       *synthetic_train_batches(cfg_t, seed + 17,
                                                                canvases=canvases), topk_train)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()

    def step(tr, label):
        t = time.perf_counter()
        m = tr.run_step().resolve()  # read now: the clock holds the device's time
        ms = (time.perf_counter() - t) * 1e3
        log(f"[17] step {tr.state.step} ({label}) {ms:.1f} ms: "
            + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
        return ms

    pool_in = []
    real_pool = meta_arch.roi_pool_max

    def record_pool(feats, boxes, *a):
        pool_in.append((feats.detach().clone(), boxes.clone()))
        return real_pool(feats, boxes, *a)

    meta_arch.roi_pool_max = record_pool
    try:
        step(trainer, "warm-up, ROIPool's inputs kept")
    finally:
        meta_arch.roi_pool_max = real_pool
    for _ in range(TRAIN_WARMUP - 1):
        step(trainer, "warm-up")
    sync()
    reset_peak()
    reset_launch_counts()
    times = [step(trainer, "timed") for _ in range(DOCK_TRAIN_STEPS)]
    launches = read_launch_counts()
    med = float(np.median(times))
    imgs = 2 * strong[0]["image"].shape[0]
    log(f"[17] {DOCK_TRAIN_STEPS} timed dock train steps on {canvases} ({n_trainable / 1e6:.1f} "
        f"M trainable params, dropout {trainer.dropout}): median {med:.2f} ms (min "
        f"{min(times):.2f}, max {max(times):.2f}), {1e3 * imgs / med:.2f} images/s ({imgs} a "
        f"step), peak device memory {peak_mib():.1f} MiB; launches {launches} (want none: the "
        f"proposals come with the batches)")
    if launches != none or not trainer.dropout:
        raise AssertionError(f"a dock train step with proposals launched a kernel or ran no "
                             f"dropout: {launches}")
    if any(k.startswith("loss_rpn") for k in trainer.metrics_history[-1]):
        raise AssertionError("the RPN trained on a stream with proposals")
    by_path["dock"] = launches
    if not all(np.isfinite(v) for m in trainer.metrics_history for v in m.values()):
        raise AssertionError("a dock train step without finite losses")
    if on_card:
        profile_run(trainer.run_step, "[17]", "dock train step", top=15)
    del trainer, strong, weak
    free()

    per_stream = cfg_t.SOLVER.IMS_PER_BATCH
    strong, weak = with_dock_proposals(
        writer["mcg_like_proposals"], rng,
        *synthetic_train_batches(cfg_t, seed + 18, n_batches=1, per_stream=per_stream,
                                 canvases=canvases), topk_train)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    sync()
    reset_peak()
    reset_launch_counts()
    ms_full = step(trainer, f"{per_stream} + {per_stream} images")
    launches = read_launch_counts()
    log(f"[17] one step at IMS_PER_BATCH {per_stream} ({per_stream} strong + {per_stream} weak "
        f"images, {per_stream * (mc.roi_batch_size + mc.weak_proposal_count)} ROIs through the "
        f"head): {ms_full:.1f} ms (the first at this shape), {1e3 * 2 * per_stream / ms_full:.2f} "
        f"images/s, peak device memory {peak_mib():.1f} MiB; launches {launches}")
    if launches != none or not all(np.isfinite(v) for v in
                                   trainer.metrics_history[-1].values()):
        raise AssertionError(f"the {per_stream}-image dock step: {launches}, "
                             f"{trainer.metrics_history[-1]}")
    by_path["dock_full_batch"] = launches
    del trainer, solver, model, strong, weak
    free()

    # (d) the YAML alone (no proposal file): the RPN proposes for the strong
    # stream (K3, one launch a step) and trains on it; the weak slots are
    # all invalid (R12); a request runs the RPN's NMS and the final one
    model = flagship_model(cfg_t, seed, dev)
    solver = build_optimizer(cfg_t, model)
    strong, weak = with_dock_proposals(
        writer["mcg_like_proposals"], rng,
        *synthetic_train_batches(cfg_t, seed + 19, n_batches=2, canvases=canvases), topk_train,
        weak_files=False)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    step(trainer, "warm-up, the YAML alone")
    sync()
    reset_launch_counts()
    times = [step(trainer, "timed, the YAML alone") for _ in range(DOCK_YAML_STEPS)]
    launches = read_launch_counts()
    per_step = {k: v / DOCK_YAML_STEPS for k, v in launches.items()}
    last = trainer.metrics_history[-1]
    log(f"[17] {DOCK_YAML_STEPS} dock train steps from the YAML alone: median "
        f"{np.median(times):.2f} ms; launches a step {per_step} (want K3 1 for the 2 strong "
        f"images); losses {sorted(last)}")
    want = dict(none, nms_mask=1, nms_mask_images=strong[0]["image"].shape[0])
    if per_step != want or "loss_rpn_cls" not in last or not all(
            np.isfinite(v) for m in trainer.metrics_history for v in m.values()):
        raise AssertionError(f"a dock step from the YAML alone: {per_step}, {last}")
    by_path["dock_yaml"] = launches
    del trainer, solver
    model.eval()
    svc = DetectionService(cfg, model, class_names=COCO_CLASSES)
    svc.warmup()
    sync()
    reset_launch_counts()
    n_dets = [len(svc.detect_array(im)) for im in images[:2]]
    launches = read_launch_counts()
    log(f"[17] 2 requests from the YAML alone (the RPN over VGG-CNN-F): detections {n_dets}, "
        f"launches {launches}")
    if launches != dict(none, nms_mask=4, nms_mask_images=4):
        raise AssertionError(f"a dock request from the YAML alone did not run K3 x2: {launches}")
    by_path["dock_yaml_serving"] = launches
    del svc, model
    free()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model32 = flagship_model(cfg32, seed, dev)
    build_optimizer(cfg32, model32)
    strong32 = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    weak32 = {k: torch.as_tensor(v, device=dev) for k, v in weak[0].items()}
    train_path_kernels_vs_plain(model32, strong32, weak32, seed, "[17]")
    del model32, strong32, weak32, strong, weak
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    free()

    # (e) ROIPool at (c)'s own inputs: a layer of the step (plain torch, as
    # XLA in unit_tpu), forward and backward; its backward twice bit-identical
    pool = {}
    if on_card:
        p, scale = mc.pooler_resolution, mc.pooler_scale
        for name, (feats, boxes) in zip(("strong", "weak"), pool_in):
            out = roi_pool_max(feats, boxes, p, scale)
            g = torch.randn_like(out)
            leaf = feats.clone().requires_grad_(True)

            def fwd_bwd():
                return torch.autograd.grad(roi_pool_max(leaf, boxes, p, scale), leaf, g)[0]

            d1, d2 = fwd_bwd(), fwd_bwd()
            f_ms = cuda_ms(lambda: roi_pool_max(feats, boxes, p, scale), 10)
            fb_ms = cuda_ms(fwd_bwd, 10)
            f_least = bound(nbytes(feats, boxes, out), 0)
            b_least = bound(nbytes(g, boxes, feats), 0)
            log(f"[17] ROIPool, {name} stream of the step: {list(feats.shape)} {feats.dtype} x "
                f"{list(boxes.shape)} -> {list(out.shape)}: forward {f_ms:.4f} ms (bound "
                f"{f_least['bound_ms']:.4f}), backward {fb_ms - f_ms:.4f} ms (forward + backward "
                f"{fb_ms:.4f}; bound {b_least['bound_ms']:.4f}), backward twice bit-identical "
                f"{torch.equal(d1, d2)}")
            if not torch.equal(d1, d2):
                raise AssertionError("ROIPool's backward is not deterministic")
            pool[name] = {"fwd_ms": f_ms, "bwd_ms": fb_ms - f_ms,
                          "fwd_bound_ms": f_least["bound_ms"], "bwd_bound_ms": b_least["bound_ms"]}
        log(f"[17] ROIPool a step (both streams, forward + backward): "
            f"{sum(v['fwd_ms'] + v['bwd_ms'] for v in pool.values()):.3f} ms of the median "
            f"step's {med:.2f} ms")
    del pool_in[:]
    free()

    # (f) the run loop on phase 12's shapes-COCO devkit with proposal
    # pickles: 4 steps, a checkpoint and an evaluation at 2, a resume from 2
    root = os.path.join(workdir, "shapes_coco")
    if not os.path.isdir(root):
        runpy.run_path(str(ROOT / "scripts" / "make_shapes_coco_torch.py"))[
            "write_shapes_coco"](root, COCO_TRAIN_IMAGES, COCO_VAL_IMAGES, COCO_IMAGE_SIZE, seed)
    for src, dst in (("val2017", "val2014"),
                     (os.path.join("annotations", "instances_val2017.json"),
                      os.path.join("annotations", "instances_val2014.json"))):
        if not os.path.exists(os.path.join(root, dst)):
            os.symlink(os.path.basename(src), os.path.join(root, dst))
    train_file, val_file = writer["write_proposals"](root, ("train2014", "val2014"),
                                                     per_image=topk_test, seed=seed)
    made = []

    class Recording(TrainerNoMeta):
        """The runner's trainer, kept so that the script can read its losses."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def run(out, *flags):
        DatasetCatalog.clear()
        made.clear()
        args = runner.default_argument_parser().parse_args([
            "--config-file", str(DOCK_RECIPE), "--data-root", root, "--device", RUN_DEVICE,
            *flags, "OUTPUT_DIR", out,
            "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
            "DATASETS.CLASSIFIER_DATAROOT", root, "SEED", str(seed),
            "DATASETS.PROPOSAL_FILES_TRAIN", f"('{train_file}',)",
            "DATASETS.PROPOSAL_FILES_CLASSIFIER_TRAIN", f"('{train_file}',)",
            "DATASETS.PROPOSAL_FILES_TEST", f"('{val_file}',)",
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(DOCK_RUN_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(DOCK_RUN_STEPS // 2),
            "TEST.EVAL_PERIOD", str(DOCK_RUN_STEPS // 2),
            "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
            *RUN_EXTRA_OPTS])
        t = time.perf_counter()
        results = runner.run(args)
        sync()
        trainer = made[-1]
        first = trainer.state.step - len(trainer.metrics_history)
        losses = {first + 1 + k: {n: v for n, v in m.items() if n != "data_time"}
                  for k, m in enumerate(trainer.metrics_history)}
        return results, losses, time.perf_counter() - t

    out_a, out_b = os.path.join(workdir, "dock_run_a"), os.path.join(workdir, "dock_run_b")
    real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
    try:
        reset_launch_counts()
        results_a, losses_a, secs = run(out_a)
        launches = read_launch_counts()
        bbox = {k: results_a["bbox"][k] for k in ("AP", "AP50", "AP75", "novel_mean")}
        for k, m in losses_a.items():
            log(f"[17]   run step {k}: " + ", ".join(f"{n} {v:.4g}" for n, v in m.items()))
        log(f"[17] run with proposal files: {len(losses_a)} steps with a checkpoint and an "
            f"evaluation every {DOCK_RUN_STEPS // 2} in {secs:.1f} s; bbox " + ", ".join(
                f"{k} {v:.4g}" for k, v in bbox.items()) + f"; launches {launches}")
        if not (sorted(losses_a) == list(range(1, DOCK_RUN_STEPS + 1))
                and all(np.isfinite(v) for m in losses_a.values() for v in m.values())
                and not any(n.startswith("loss_rpn") for m in losses_a.values() for n in m)
                and all(np.isfinite(v) for v in bbox.values())
                and os.path.exists(os.path.join(out_a, f"step_{DOCK_RUN_STEPS // 2}.pt"))):
            raise AssertionError("the dock run left out a step, a checkpoint or a finite loss "
                                 "or AP, or trained the RPN")
        by_path["dock_run"] = launches
        os.makedirs(out_b)
        shutil.copy(os.path.join(out_a, f"step_{DOCK_RUN_STEPS // 2}.pt"), out_b)
        _, losses_b, secs = run(out_b, "--resume")
        rel = max(abs(losses_b[k][n] - losses_a[k][n]) / max(abs(losses_a[k][n]), 1e-12)
                  for k in losses_b for n in losses_b[k])
        same = all(losses_b[k][n] == losses_a[k][n] for k in losses_b for n in losses_b[k])
        log(f"[17] resumed from step {DOCK_RUN_STEPS // 2} in {secs:.1f} s: steps "
            f"{sorted(losses_b)}, losses bit-identical to the uninterrupted run's {same} (max "
            f"rel diff {rel:.3g}, tol {RESUME_LOSS_RTOL})")
        if sorted(losses_b) != list(range(DOCK_RUN_STEPS // 2 + 1, DOCK_RUN_STEPS + 1)) \
                or not rel <= RESUME_LOSS_RTOL:
            raise AssertionError("the resumed dock run does not reproduce its steps")
    finally:
        runner.TrainerNoMeta = real_trainer
        made.clear()
    free()

    # (g) one image under TEST.AUG.ENABLED with proposals: the file's boxes in
    # the canonical frame, rescaled and mirrored for every variant; the
    # RPN and the canonical backbone pass skipped
    cfg_a = cfg.clone()
    cfg_a.TEST.AUG.ENABLED = True
    model = flagship_model(cfg_a, seed, dev)
    base_t = TransformConfig.test_from_cfg(cfg_a)
    base_t.proposal_capacity = topk_test
    variant_cfgs = tta_variant_configs(cfg_a, max_aspect_of(records[:1]))
    batch = prepare_tta_batch(records[0], images[0], base_t, variant_cfgs)
    tta = make_tta_predict_fn(model, tta_topk=cfg_a.TPU.TTA_PROPOSAL_TOPK)

    def tta_request():
        d = tta(batch)
        return d.valid.cpu(), d.scores.cpu()

    tta_request()  # warm-up
    sync()
    reset_launch_counts()
    times = []
    for _ in range(TTA_TIMED):
        t0 = time.perf_counter()
        valid, scores = tta_request()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launch_counts()
    per_image = {k: v / TTA_TIMED for k, v in launches.items()}
    log(f"[17] TTA with proposals, one {DOCK_REQUEST_SHAPES[0]} image, {len(batch['variants'])} "
        f"variants over {len(variant_cfgs) // (2 if cfg_a.TEST.AUG.FLIP else 1)} scales: ms "
        f"{[round(v, 1) for v in times]}, {int(valid.sum())} detections; launches an image "
        f"{per_image}")
    if per_image != dict(none, nms_mask=1, nms_mask_images=1) or not torch.isfinite(
            scores).all():
        raise AssertionError(f"the dock TTA with proposals: {per_image}")
    by_path["dock_tta"] = launches
    del model, tta
    free()
    log(f"[17] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return by_path, k3_dock


# Serving surface (phase 18): the flagship served at batch 1 and micro-batched
# at SERVE_BATCH under SERVE_CLIENTS client threads (scripts/bench_serving_torch.py's
# load generator), SERVE_REQUESTS seeded requests of a VOC image's size in both
# orientations; torch.export artifacts of the flagship and of the dock recipe
# with proposals; the HTTP front end; the serving CLIs as subprocesses.
SERVE_REQUESTS = 16
SERVE_CLIENTS = 8
SERVE_BATCH = 4
SERVE_WAIT_MS = 10.0
SERVE_SHAPES = ((375, 500), (500, 375))
# A micro-batched request against the same request at batch 1, in f32 with
# TF32 off (tests/test_serving.py:139-142): the batch-4 and batch-1 calls pick
# their convolution algorithms apart, so boxes move by float noise, far under
# 1e-2 px, and scores under 1e-4; the counts and classes are the same.
BATCH_BOX_ATOL, BATCH_BOX_RTOL = 1e-2, 1e-4
BATCH_SCORE_ATOL, BATCH_SCORE_RTOL = 1e-4, 1e-3
# An artifact against the live predict in one process (tests/test_serving.py:
# 84-90): the program runs the same aten operations and kernels on the same
# weights, so they should agree bit for bit; these bounds hold where not.
EXPORT_BOX_ATOL, EXPORT_BOX_RTOL = 1e-5, 1e-6
EXPORT_SCORE_ATOL, EXPORT_SCORE_RTOL = 1e-6, 1e-6
HTTP_REQUESTS = 4
CLI_START_S = 300   # the serving CLI's start: torch, the artifact, its warm-up
CLI_STOP_S = 10     # SIGTERM to exit


def match_detections(got, want, box_atol, box_rtol, score_atol, score_rtol):
    """(every detection of ``want`` has its own in ``got`` (same class, box and
    score within the bounds) and the counts are equal, max |box diff|, max
    |score diff|) of two detection lists, matched by class and distance."""
    used, worst_box, worst_score, ok = set(), 0.0, 0.0, len(got) == len(want)
    for w in want:
        best = None
        for j, g in enumerate(got):
            if j in used or g["class_id"] != w["class_id"]:
                continue
            db = float(np.abs(np.subtract(g["box"], w["box"])).max())
            if best is None or db < best[1]:
                best = (j, db, abs(g["score"] - w["score"]))
        if best is None:
            ok = False
            continue
        j, db, ds = best
        used.add(j)
        worst_box, worst_score = max(worst_box, db), max(worst_score, ds)
        box_tol = box_atol + box_rtol * float(np.abs(w["box"]).max())
        ok &= db <= box_tol and ds <= score_atol + score_rtol * abs(w["score"])
    return ok, worst_box, worst_score


def file_mib(path):
    return os.path.getsize(path) / 2**20


def phase_serving(cfg, seed, workdir):
    """Phase 18: the serving surface at the flagship's full width.  (a) the
    live DetectionService at batch 1 and micro-batched at SERVE_BATCH under
    SERVE_CLIENTS clients: req/s, p50/p99, each device call's batch size and
    its launches; (b) micro-batched against batch 1 in f32 with TF32 off;
    (c) torch.export artifacts at SERVE_BATCH (landscape) and at batch 1
    (portrait): export seconds, MiB, each artifact against the live predict
    (one batch, one portrait request), its launches, and the batch artifact
    served through the service; (d) the dock recipe's artifact with 5000
    proposals on one request against make_predict_fn, its launches, and the
    service refusing it; (e)
    DetectionServer on 127.0.0.1 over (b)'s batch service; (f)
    scripts/serve_torch.py --artifact and scripts/export_model_torch.py
    --describe as subprocesses.  Returns {path: launch counts}."""
    import runpy
    import signal
    import urllib.error
    import urllib.request

    import torch
    from PIL import Image

    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data.proposals import attach_proposals
    from unit_tpu_torch.data.transforms import (TransformConfig, prepare_detection_record,
                                                prepare_test_image)
    from unit_tpu_torch.engine.predict import make_predict_fn
    from unit_tpu_torch.models.similarity import VOC_CLASSES
    from unit_tpu_torch.serving import (DetectionServer, DetectionService, export_predict,
                                        load_exported)

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    bench = runpy.run_path(str(ROOT / "scripts" / "bench_serving_torch.py"))
    writer = runpy.run_path(str(ROOT / "scripts" / "make_shapes_proposals_torch.py"))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        if on_card:
            torch.cuda.empty_cache()

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak_mib():
        return torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0

    def recording(svc):
        """Record the batch size of each of the micro-batcher's device calls."""
        calls = []
        inner = svc._batcher._predict
        svc._batcher._predict = lambda i, s: (calls.append(i.shape[0]), inner(i, s))[1]
        return calls

    def serve(svc, requests, mode="array"):
        bench["run"](svc, requests[: SERVE_CLIENTS * 2], SERVE_CLIENTS, mode)  # warm
        return bench["run"](svc, requests, SERVE_CLIENTS, mode)

    cfg = cfg.clone()
    cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    rng = np.random.RandomState(seed + 180)
    images = [rng.uniform(0, 255, SERVE_SHAPES[i % 2] + (3,)).astype(np.float32)
              for i in range(SERVE_REQUESTS)]
    none = {"roi_align_fwd": 0, "roi_align_bwd": 0, "nms_mask": 0, "nms_mask_images": 0,
            "bn_act_fwd": 0, "bn_act_bwd": 0, "bn_act_layout_copies": 0}
    by_path = {}

    # (a) the live service at batch 1 and micro-batched
    model = flagship_model(cfg, seed, dev)
    n_backbone, n_res5, _ = frozen_bn_counts(model)
    k4_call = n_backbone + (2 if model.mc.multi_box_head else 1) * n_res5

    def want_launches(calls):
        """K1 once a call, K3 once for the RPN of the call's images and once
        for each image's final NMS, K4 once a FrozenBN a call."""
        return dict(none, roi_align_fwd=len(calls), nms_mask=sum(1 + b for b in calls),
                    nms_mask_images=sum(2 * b for b in calls), bn_act_fwd=k4_call * len(calls))

    svc1 = DetectionService(cfg, model, class_names=VOC_CLASSES)
    svc1.warmup()
    reset_launch_counts()
    rps1, p50_1, p99_1, _, res1 = serve(svc1, images)
    log(f"[18] (a) batch 1, {SERVE_CLIENTS} clients, {SERVE_REQUESTS} requests of "
        f"{SERVE_SHAPES}: {rps1:.2f} req/s, p50 {p50_1:.1f} ms, p99 {p99_1:.1f} ms; launches "
        f"(warm-up run included) {read_launch_counts()}")
    svc4 = DetectionService(cfg, model, class_names=VOC_CLASSES, batch_size=SERVE_BATCH,
                            batch_wait_ms=SERVE_WAIT_MS)
    calls = recording(svc4)
    t0 = time.perf_counter()
    svc4.warmup()
    sync()
    log(f"[18] (a) batch {SERVE_BATCH} warm-up, both orientations x batches {sorted(set(calls))}:"
        f" {time.perf_counter() - t0:.2f} s")
    bench["run"](svc4, images[: SERVE_CLIENTS * 2], SERVE_CLIENTS, "array")
    calls.clear()
    reset_peak()
    reset_launch_counts()
    rps4, p50_4, p99_4, _, res4 = bench["run"](svc4, images, SERVE_CLIENTS, "array")
    launches = read_launch_counts()
    log(f"[18] (a) batch {SERVE_BATCH} micro-batched (wait {SERVE_WAIT_MS} ms): {rps4:.2f} req/s "
        f"({rps4 / rps1:.2f}x batch 1), p50 {p50_4:.1f} ms, p99 {p99_4:.1f} ms; {len(calls)} "
        f"device calls of batch {calls}; peak {peak_mib():.1f} MiB; launches {launches}, a call "
        f"K1 {launches['roi_align_fwd'] / max(len(calls), 1):.2f}, K3 "
        f"{launches['nms_mask'] / max(len(calls), 1):.2f}, K4 "
        f"{launches['bn_act_fwd'] / max(len(calls), 1):.2f}")
    if not (calls and all(b in (1, 2, 4) for b in calls) and len(calls) < SERVE_REQUESTS):
        raise AssertionError(f"the micro-batcher's calls {calls} are not power-of-two batches "
                             f"fewer than the {SERVE_REQUESTS} requests")
    if on_card and launches != want_launches(calls):
        raise AssertionError(f"the micro-batched calls {calls} did not launch K1 x1, K3 x(1 + b) "
                             f"and K4 x{k4_call} each: {launches}, want {want_launches(calls)}")
    by_path["serving_micro"] = launches
    same = [match_detections(g, w, BATCH_BOX_ATOL, BATCH_BOX_RTOL, BATCH_SCORE_ATOL,
                             BATCH_SCORE_RTOL) for g, w in zip(res4, res1)]
    log(f"[18] (a) bf16, batch {SERVE_BATCH} against batch 1 (reported, not gated): "
        f"{sum(s[0] for s in same)} of {SERVE_REQUESTS} requests within the f32 bounds, "
        f"detections {sum(map(len, res4))} vs {sum(map(len, res1))}, max |box diff| "
        f"{max(s[1] for s in same):.4g} px, max |score diff| {max(s[2] for s in same):.4g}")
    for img, dets in zip(images, res4):
        h, w = img.shape[:2]
        for d in dets:
            x1, y1, x2, y2 = d["box"]
            if not (np.isfinite(d["box"]).all() and 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
                    and 0 < d["score"] <= 1):
                raise AssertionError(f"a served detection outside the image or range: {d}")
    svc1.close()
    svc4.close()

    # (c) artifacts of the live model, in this process
    tcfg = TransformConfig.test_from_cfg(cfg)
    path4 = os.path.join(workdir, f"flagship_b{SERVE_BATCH}.pt2.pkl")
    reset_peak()
    t0 = time.perf_counter()
    meta4 = export_predict(cfg, model, path4, class_names=VOC_CLASSES, batch_size=SERVE_BATCH,
                           orientations="landscape")
    log(f"[18] (c) exported {meta4['canvases']} at batch {SERVE_BATCH} in "
        f"{time.perf_counter() - t0:.1f} s: {file_mib(path4):.1f} MiB, peak {peak_mib():.1f} "
        f"MiB, {meta4['platforms']}, torch {meta4['torch_version']}")
    art4 = load_exported(path4)
    predict = make_predict_fn(model)
    prepared = [prepare_test_image(im, tcfg) for im in images[0::2][:SERVE_BATCH]]
    batch = [np.stack([p[k] for p in prepared]) for k in ("image", "image_size")]
    reset_launch_counts()
    got = art4(*batch)
    sync()
    launches = read_launch_counts()
    want = predict(*batch)
    identical = all(torch.equal(getattr(got, f), getattr(want, f))
                    for f in ("boxes", "scores", "classes", "valid"))
    v = want.valid
    if not torch.equal(got.valid, v) or not torch.equal(got.classes[v], want.classes[v]):
        raise AssertionError("the artifact's valid detections or classes differ from the "
                             "live predict's")
    if not (torch.allclose(got.boxes[v], want.boxes[v], rtol=EXPORT_BOX_RTOL,
                           atol=EXPORT_BOX_ATOL)
            and torch.allclose(got.scores[v], want.scores[v], rtol=EXPORT_SCORE_RTOL,
                               atol=EXPORT_SCORE_ATOL)):
        raise AssertionError("the artifact's boxes or scores differ from the live predict's "
                             "beyond tests/test_serving.py's bounds")
    worst = ((float((got.boxes[v] - want.boxes[v]).abs().max()),
              float((got.scores[v] - want.scores[v]).abs().max())) if v.any() else (0.0, 0.0))
    log(f"[18] (c) batch-{SERVE_BATCH} artifact against the live predict on {SERVE_BATCH} "
        f"landscape requests: valid and classes identical, bit-identical {identical}, max "
        f"|box diff| {worst[0]:.3g}, max |score diff| {worst[1]:.3g}; launches {launches}")
    if on_card and launches != want_launches([SERVE_BATCH]):
        raise AssertionError(f"the artifact's call did not launch "
                             f"{want_launches([SERVE_BATCH])}: {launches}")
    by_path["serving_artifact_predict"] = launches
    del got, want
    free()
    svc_a = DetectionService(cfg, exported=art4)
    if svc_a.batch_size != SERVE_BATCH or svc_a.class_names != list(VOC_CLASSES):
        raise AssertionError("the service did not take the artifact's batch size and names")
    calls = recording(svc_a)
    svc_a.warmup()  # the landscape program only: the artifact has no other
    landscape = images[0::2]
    bench["run"](svc_a, landscape[:SERVE_CLIENTS], SERVE_CLIENTS, "array")
    calls.clear()
    reset_launch_counts()
    rps_a, p50_a, p99_a, _, _ = bench["run"](svc_a, landscape, SERVE_CLIENTS, "array")
    launches = read_launch_counts()
    log(f"[18] (c) batch-{SERVE_BATCH} artifact through the service, {len(landscape)} landscape "
        f"requests, {SERVE_CLIENTS} clients: {rps_a:.2f} req/s, p50 {p50_a:.1f} ms, p99 "
        f"{p99_a:.1f} ms; calls {calls}; launches {launches}")
    if not (calls and set(calls) == {SERVE_BATCH}):
        raise AssertionError(f"the artifact's calls are not all of batch {SERVE_BATCH}: {calls}")
    if on_card and launches != want_launches(calls):
        raise AssertionError(f"the batch artifact's launches {launches} are not "
                             f"{want_launches(calls)}")
    by_path["serving_artifact"] = launches
    svc_a.close()
    del svc_a, art4
    free()

    # (f)'s CLIs start here, as a user starts them, and come up while the
    # batch-1 artifact, (b), (e) and (d) run: their start-up (torch, the
    # artifact, its warm-up) is most of their time
    cmd = [sys.executable, str(ROOT / "scripts" / "serve_torch.py"), "--config-file",
           str(FLAGSHIP), "--artifact", path4, "--host", "127.0.0.1", "--port", "0",
           "--device", RUN_DEVICE, *RUN_EXTRA_OPTS, "OUTPUT_DIR", os.path.join(workdir, "serve")]
    t_cli = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=workdir)
    describe = subprocess.Popen([sys.executable, str(ROOT / "scripts" / "export_model_torch.py"),
                                 "--describe", path4], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    for p in (proc, describe):  # stopped however this script ends
        atexit.register(lambda p=p: p.poll() is None and (p.kill(), p.communicate()))
    lines = []

    def serving_line():
        for out_line in iter(proc.stdout.readline, ""):
            lines.append(out_line)
            if out_line.startswith("serving on "):
                return (out_line, time.perf_counter() - t_cli)
        return None

    reader = concurrent.futures.ThreadPoolExecutor(1)
    serving = reader.submit(serving_line)

    # (c) the batch-1 artifact of the portrait canvas, on one portrait
    # request, while the CLIs come up
    path1 = os.path.join(workdir, "flagship_b1.pt2.pkl")
    reset_peak()
    t0 = time.perf_counter()
    meta1 = export_predict(cfg, model, path1, class_names=VOC_CLASSES, batch_size=1,
                           orientations="portrait")
    log(f"[18] (c) exported {meta1['canvases']} at batch 1 in {time.perf_counter() - t0:.1f} s: "
        f"{file_mib(path1):.1f} MiB, peak {peak_mib():.1f} MiB")
    art1 = load_exported(path1)
    s = prepare_test_image(images[1], tcfg)
    if s["image"].shape[0] <= s["image"].shape[1]:
        raise AssertionError(f"request 1 is not on the portrait canvas: {s['image'].shape}")
    args1 = (s["image"][None], s["image_size"][None])
    reset_launch_counts()
    got = art1(*args1)
    sync()
    launches = read_launch_counts()
    want = predict(*args1)
    identical = all(torch.equal(getattr(got, f), getattr(want, f))
                    for f in ("boxes", "scores", "classes", "valid"))
    v = want.valid
    if not (torch.equal(got.valid, v) and torch.equal(got.classes[v], want.classes[v])
            and torch.allclose(got.boxes[v], want.boxes[v], rtol=EXPORT_BOX_RTOL,
                               atol=EXPORT_BOX_ATOL)
            and torch.allclose(got.scores[v], want.scores[v], rtol=EXPORT_SCORE_RTOL,
                               atol=EXPORT_SCORE_ATOL)):
        raise AssertionError("the batch-1 artifact's detections differ from the live predict's "
                             "beyond tests/test_serving.py's bounds")
    log(f"[18] (c) batch-1 artifact against the live predict on a portrait request: valid and "
        f"classes identical, bit-identical {identical}; launches {launches}")
    if on_card and launches != want_launches([1]):
        raise AssertionError(f"the batch-1 artifact did not launch {want_launches([1])}: "
                             f"{launches}")
    by_path["serving_artifact_b1"] = launches
    del art1, got, want, model, predict
    free()

    # (b) micro-batched against batch 1 in f32 with TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = flagship_model(cfg32, seed, dev)
    s1 = DetectionService(cfg32, model32, class_names=VOC_CLASSES)
    s4 = DetectionService(cfg32, model32, class_names=VOC_CLASSES, batch_size=SERVE_BATCH,
                          batch_wait_ms=SERVE_WAIT_MS)
    s1.warmup()
    s4.warmup()
    calls = recording(s4)
    reqs = images[:2 * HTTP_REQUESTS]
    single = [s1.detect_array(im) for im in reqs]
    batched = bench["run"](s4, reqs, SERVE_CLIENTS, "array")[4]
    same = [match_detections(g, w, BATCH_BOX_ATOL, BATCH_BOX_RTOL, BATCH_SCORE_ATOL,
                             BATCH_SCORE_RTOL) for g, w in zip(batched, single)]
    log(f"[18] (b) f32, TF32 off: batch {SERVE_BATCH} (calls {calls}) against batch 1 on "
        f"{len(reqs)} requests: {sum(s[0] for s in same)} within the bounds, detections "
        f"{sum(map(len, batched))} vs {sum(map(len, single))}, max |box diff| "
        f"{max(s[1] for s in same):.3g} px (tol {BATCH_BOX_ATOL}), max |score diff| "
        f"{max(s[2] for s in same):.3g} (tol {BATCH_SCORE_ATOL})")
    if not all(s[0] for s in same) or max(calls) < 2 or sum(map(len, single)) == 0:
        raise AssertionError("micro-batched f32 requests differ from batch 1 beyond the bounds "
                             "(or no call was batched, or nothing was detected)")

    # (e) the HTTP front end over (b)'s batch service
    def http(base, path, data=None):
        req = urllib.request.Request(base + path, data=data,
                                     method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    def jpeg(img):
        buf = io.BytesIO()
        Image.fromarray(img[:, :, ::-1].astype(np.uint8)).save(buf, format="JPEG", quality=90)
        return buf.getvalue()

    jpegs = [jpeg(im) for im in images[:HTTP_REQUESTS]]
    server = DetectionServer(s4, host="127.0.0.1", port=0,
                             metadata={"config": str(FLAGSHIP.relative_to(ROOT))})
    server.start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        health, meta_reply = http(base, "/healthz"), http(base, "/metadata")
        with concurrent.futures.ThreadPoolExecutor(HTTP_REQUESTS) as pool:
            replies = list(pool.map(lambda p: http(base, "/predict", p), jpegs))
        direct = bench["run"](s4, jpegs, HTTP_REQUESTS, "bytes")[4]
        bad, unknown = http(base, "/predict", b"not an image"), http(base, "/nowhere")
    finally:
        server.shutdown()  # closes s4's micro-batcher
    same = [code == 200 and match_detections(body["detections"], d, BATCH_BOX_ATOL,
                                             BATCH_BOX_RTOL, BATCH_SCORE_ATOL,
                                             BATCH_SCORE_RTOL)[0]
            for (code, body), d in zip(replies, direct)]
    identical = sum(code == 200 and body["detections"] == d for (code, body), d in
                    zip(replies, direct))
    log(f"[18] (e) HTTP on 127.0.0.1:{server.port}: /healthz {health}, /metadata {meta_reply[0]},"
        f" {HTTP_REQUESTS} concurrent JPEG POSTs {[c for c, _ in replies]}: {sum(same)} equal to "
        f"detect_bytes within (b)'s bounds ({identical} identical), detections "
        f"{[len(b['detections']) for _, b in replies]}; garbage -> {bad[0]}, unknown path -> "
        f"{unknown[0]}")
    if not (health == (200, {"status": "ok"}) and meta_reply[0] == 200 and all(same)
            and bad[0] == 400 and unknown[0] == 404):
        raise AssertionError("the HTTP front end did not answer as DetectionService does")
    s1.close()
    del s1, s4, model32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    free()

    # (d) the dock recipe's artifact with proposals at full width: one
    # landscape request
    dcfg = get_cfg()
    dcfg.merge_from_file(str(DOCK_RECIPE))
    dcfg.merge_from_list(list(RUN_EXTRA_OPTS))
    topk = dcfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
    dtcfg = TransformConfig.test_from_cfg(dcfg)
    dtcfg.proposal_capacity = topk
    h, w = DOCK_REQUEST_SHAPES[0]
    dimage = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, 4)) * [w / 2, h / 2, w / 2, h / 2]
    gt[:, 2:] += gt[:, :2] + 16
    boxes, scores = writer["mcg_like_proposals"](gt, w, h, rng, per_image=topk)
    prop_path = os.path.join(workdir, "serving_proposals.pkl")
    with open(prop_path, "wb") as f:
        pickle.dump({"0": {"boxes": boxes, "scores": scores}}, f)
    records = [{"image_id": "0", "height": h, "width": w, "annotations": []}]
    attach_proposals(records, [prop_path], topk)
    s = prepare_detection_record(records[0], dtcfg, None, image=dimage, training=False)
    dargs = (s["image"][None], s["image_size"][None], s["proposals"][None],
             s["proposals_valid"][None])
    dcfg.DATASETS.PROPOSAL_FILES_TEST = (prop_path,)
    dmodel = flagship_model(dcfg, seed, dev)
    dpath = os.path.join(workdir, "dock_b1.pt2.pkl")
    reset_peak()
    t0 = time.perf_counter()
    dmeta = export_predict(dcfg, dmodel, dpath, orientations="landscape")
    log(f"[18] (d) dock artifact {dmeta['canvases']} with {dmeta['proposal_capacity']} proposals "
        f"a request exported in {time.perf_counter() - t0:.1f} s: {file_mib(dpath):.1f} MiB, "
        f"peak {peak_mib():.1f} MiB")
    dart = load_exported(dpath)
    reset_launch_counts()
    dgot = dart(*dargs)
    sync()
    launches = read_launch_counts()
    dwant = make_predict_fn(dmodel)(*dargs)
    identical = all(torch.equal(getattr(dgot, f), getattr(dwant, f))
                    for f in ("boxes", "scores", "classes", "valid"))
    log(f"[18] (d) dock artifact against make_predict_fn on a {h}x{w} request: identical "
        f"{identical}, detections {int(dgot.valid.sum())}; launches {launches}")
    if not identical:
        raise AssertionError("the dock artifact's detections differ from make_predict_fn's")
    if on_card and launches != dict(none, nms_mask=1, nms_mask_images=1):
        raise AssertionError(f"the dock artifact did not launch K3 x1 and nothing else: "
                             f"{launches}")
    by_path["dock_artifact"] = launches
    try:
        DetectionService(dcfg, exported=dart)
    except ValueError as e:
        log(f"[18] (d) DetectionService refuses the artifact: {str(e)[:80]}...")
    else:
        raise AssertionError("DetectionService took an artifact exported with proposals")
    del dart, dmodel, dgot, dwant
    free()

    # (f) the CLIs started after (c)
    try:
        ready = serving.result(timeout=max(CLI_START_S - (time.perf_counter() - t_cli), 1.0))
        if ready is None:
            raise AssertionError("serve_torch.py exited before serving:\n" + "".join(lines))
        line, start_s = ready
        base = "http://127.0.0.1:" + line.strip().rsplit(":", 1)[1]
        health = http(base, "/healthz")
        code, body = http(base, "/predict", jpegs[0])
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=CLI_STOP_S)
        stop_s = time.perf_counter() - t0
        reader.shutdown()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    log(f"[18] (f) serve_torch.py --artifact: serving after {start_s:.1f} s (started with (c)'s "
        f"batch-1 artifact, (b), (e) and (d) running), /healthz {health},"
        f" POST {code} ({len(body.get('detections', []))} detections), exit {proc.returncode} "
        f"{stop_s:.2f} s after SIGTERM")
    if not (health == (200, {"status": "ok"}) and code == 200 and proc.returncode == 0
            and "signal 15: shutting down" in rest):
        raise AssertionError("serve_torch.py did not serve and stop cleanly:\n"
                             + "".join(lines) + rest)
    out, err = describe.communicate(timeout=CLI_START_S)
    if describe.returncode != 0:
        raise AssertionError(f"export_model_torch.py --describe exited {describe.returncode}: "
                             f"{err[-2000:]}")
    described = json.loads(out)
    log(f"[18] (f) export_model_torch.py --describe: {described['canvases']} batch "
        f"{described['batch_size']} {described['platforms']}")
    if described != meta4:
        raise AssertionError(f"--describe printed {described}, not the artifact's metadata")
    log(f"[18] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return by_path


# Phase 19: the flagship learns on shapes-VOC from random weights, at the
# accuracy pipeline's size and learning rate (scripts/run_shapes_pipeline_torch.sh,
# 6000 steps there); then the kernels on the trained weights.
TRAINED_STEPS = 90         # total_loss falls ~14x by step 76 on the card: the 0.7 gate holds
TRAINED_IMS_PER_BATCH = 4  # 4 strong + 4 weak images a step
TRAINED_BASE_LR = 0.002
TRAINED_WARMUP_ITERS = 100
TRAINED_SIZE = 320         # the devkit's images and the run's INPUT sizes
TRAINED_WINDOW = 20        # the steps whose median losses open and close the run
TRAINED_LOSS_RATIO = 0.7   # tests/test_overfit.py's criterion for total_loss
# The trained weights' train step at the recipe's largest train size: a
# 320x320 image scaled to 800x800 gives a 50x50 map, 37500 anchors an image,
# so the RPN's training NMS runs at its 12000 -> 2000 shape.
TRAINED_STEP_SIZE = 800
SHAPES_VOC_SEED = 17


def shapes_voc_step_batches(devkit, cfg, size):
    """One strong and one weak batch of 2 shapes-VOC training images each,
    scaled to size x size as one canvas: the strong images carry their base
    classes' boxes (padded to TPU.MAX_GT_BOXES), the weak ones a multi-hot
    label of every class they show."""
    from unit_tpu_torch.data.transforms import load_image_bgr, resize_image
    from unit_tpu_torch.data.voc import load_voc_split

    base = set(cfg.DATASETS.FEWSHOT.BASE_CLASSES_ID)
    g_cap = cfg.TPU.MAX_GT_BOXES
    recs = load_voc_split(devkit, "2007", "trainval", None)
    strong_recs = [r for r in recs if any(a["category_id"] in base
                                          for a in r["annotations"])][:2]
    weak_recs = [r for r in recs if r not in strong_recs][:2]

    def images(rs):
        return np.stack([resize_image(load_image_bgr(r["file_name"]), size, size)
                         for r in rs]).astype(np.float32)

    boxes = np.zeros((2, g_cap, 4), np.float32)
    classes = np.zeros((2, g_cap), np.int32)
    valid = np.zeros((2, g_cap), bool)
    for i, r in enumerate(strong_recs):
        anns = [a for a in r["annotations"] if a["category_id"] in base][:g_cap]
        for j, a in enumerate(anns):
            boxes[i, j] = np.asarray(a["bbox"]) * (size / r["width"])
            classes[i, j] = a["category_id"]
            valid[i, j] = True
    labels = np.zeros((2, cfg.MODEL.ROI_HEADS.NUM_CLASSES), np.float32)
    for i, r in enumerate(weak_recs):
        for a in r["annotations"]:
            labels[i, a["category_id"]] = 1.0
    sizes = np.asarray([[size, size]] * 2, np.float32)
    strong = dict(image=images(strong_recs), gt_boxes=boxes, gt_classes=classes,
                  gt_valid=valid, image_size=sizes)
    weak = dict(image=images(weak_recs), labels=labels, image_size=sizes)
    return strong, weak


def phase_trained(cfg, seed, workdir):
    """Phase 19 in ``workdir``: (1) a shapes-VOC devkit; (2) engine.runner.run
    on the flagship recipe from random weights (MODEL.WEIGHTS "", FREEZE_AT
    0, the pipeline's learning rate and 320-pixel sizes), TRAINED_STEPS steps
    of 4 + 4 images, one checkpoint and one evaluation at the end; (3) the
    gate: the median total_loss of the last TRAINED_WINDOW steps under
    TRAINED_LOSS_RATIO x that of the first, loss_rpn_cls and loss_im_cls
    lower, every loss finite; (4) on the trained checkpoint (a) proposals kept
    an image at test settings against the random weights', (b) K3 against its
    plain version at the trained RPN's own train-step input (4 images, 12000
    -> 2000), timed beside the three synthetic layouts of phase 3, (c) the
    f32 predict and train paths kernels vs plain, (d) bf16 against f32 on the
    test images, (e) a trained step's launches under the recipe's own solver.
    Returns ({path: launch counts}, K3's numbers at the trained input)."""
    import runpy

    import torch

    from unit_tpu_torch.checkpoint import read_checkpoint
    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.transforms import (TransformConfig, load_image_bgr,
                                                prepare_test_image)
    from unit_tpu_torch.data.voc import load_voc_split
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import TrainerNoMeta
    from unit_tpu_torch.models import WSRCNN, ModelConfig
    from unit_tpu_torch.models.similarity import VOC_CLASSES
    from unit_tpu_torch.ops import nms as nms_ops
    from unit_tpu_torch.serving import DetectionService
    from unit_tpu_torch.solver import build_optimizer

    t_phase = time.perf_counter()
    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    by_path = {}

    def free():
        if on_card:
            torch.cuda.empty_cache()

    # (1) the devkit
    t0 = time.perf_counter()
    devkit = os.path.join(workdir, "shapes_voc")
    n_train, n_test = runpy.run_path(str(ROOT / "scripts" / "make_shapes_voc_torch.py"))[
        "write_shapes_voc"](devkit, size=TRAINED_SIZE, seed=SHAPES_VOC_SEED)
    log(f"[19] shapes-VOC devkit: {n_train} training images a year (VOC2007, VOC2012), "
        f"{n_test} test images at {TRAINED_SIZE}x{TRAINED_SIZE}, written in "
        f"{time.perf_counter() - t0:.1f} s")

    # (2) the run from random weights
    out = os.path.join(workdir, "trained")
    size = str(TRAINED_SIZE)
    opts = ["MODEL.WEIGHTS", "", "MODEL.BACKBONE.FREEZE_AT", "0",
            "OUTPUT_DIR", out, "SEED", str(seed),
            "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
            "DATASETS.CLASSIFIER_DATAROOT", devkit,
            "SOLVER.IMS_PER_BATCH", str(TRAINED_IMS_PER_BATCH),
            "SOLVER.BASE_LR", str(TRAINED_BASE_LR),
            "SOLVER.WARMUP_ITERS", str(TRAINED_WARMUP_ITERS),
            "SOLVER.MAX_ITER", str(TRAINED_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", str(TRAINED_STEPS), "TEST.EVAL_PERIOD", "0",
            "INPUT.MIN_SIZE_TRAIN", f"({size},)", "INPUT.MAX_SIZE_TRAIN", size,
            "INPUT.MIN_SIZE_TEST", size, "INPUT.MAX_SIZE_TEST", size, *RUN_EXTRA_OPTS]
    run_cfg = get_cfg()
    run_cfg.merge_from_file(str(FLAGSHIP))
    run_cfg.merge_from_list(opts)
    made = []

    class Recording(TrainerNoMeta):
        """TrainerNoMeta that keeps itself, so the script can read its losses."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    DatasetCatalog.clear()
    args = runner.default_argument_parser().parse_args([
        "--config-file", str(FLAGSHIP), "--data-root", devkit, "--device", RUN_DEVICE, *opts])
    real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        results = runner.run(args)
    finally:
        runner.TrainerNoMeta = real_trainer
    if on_card:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_path["trained_run"] = read_launch_counts()
    trainer = made[-1]
    history = trainer.metrics_history
    bbox = results["bbox"]
    ckpt = os.path.join(out, f"step_{TRAINED_STEPS}.pt")
    log(f"[19] run of {len(history)} steps ({TRAINED_IMS_PER_BATCH} + {TRAINED_IMS_PER_BATCH} "
        f"images at {TRAINED_SIZE}, LR {TRAINED_BASE_LR}, warm-up {TRAINED_WARMUP_ITERS}, "
        f"FREEZE_AT 0, from random weights) with a checkpoint and the final evaluation of "
        f"{n_test} images: {secs:.1f} s; launches {by_path['trained_run']}")
    log(f"[19] AP {bbox['AP']:.4g}, AP50 {bbox['AP50']:.4g}, AP75 {bbox['AP75']:.4g}, "
        f"novel_mean {bbox['novel_mean']:.4g} (reported, not gated); checkpoint "
        f"{os.path.getsize(ckpt) / 2**20:.1f} MiB")

    # (3) the gate: the loss falls
    def window_median(key, last):
        rows = history[-TRAINED_WINDOW:] if last else history[:TRAINED_WINDOW]
        return float(np.median([m[key] for m in rows]))

    keys = ("total_loss", "loss_rpn_cls", "loss_im_cls")
    first = {k: window_median(k, False) for k in keys}
    last = {k: window_median(k, True) for k in keys}
    for step in sorted({0, len(history) // 4, len(history) // 2, len(history) - 1}):
        log(f"[19]   step {step + 1}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in history[step].items() if k != "data_time"))
    ratio = last["total_loss"] / first["total_loss"]
    log(f"[19] median of the first / last {TRAINED_WINDOW} steps: " + ", ".join(
        f"{k} {first[k]:.4g} -> {last[k]:.4g}" for k in keys)
        + f"; total_loss ratio {ratio:.4g} (gate < {TRAINED_LOSS_RATIO})")
    finite = all(np.isfinite(v) for m in history for v in m.values())
    if not (finite and len(history) == TRAINED_STEPS and ratio < TRAINED_LOSS_RATIO
            and last["loss_rpn_cls"] < first["loss_rpn_cls"]
            and last["loss_im_cls"] < first["loss_im_cls"]):
        raise AssertionError(f"the flagship did not learn shapes-VOC: {first} -> {last}, "
                             f"finite {finite}")
    if not os.path.exists(ckpt):
        raise AssertionError(f"the run left no checkpoint at {ckpt}")
    del trainer, made[:]
    free()

    # the trained checkpoint, in the run's bf16 and in f32
    state = read_checkpoint(ckpt)["model"]

    def trained(dtype):
        c = run_cfg.clone()
        c.TPU.COMPUTE_DTYPE = dtype
        net = WSRCNN(ModelConfig.from_cfg(c)).to(dev).eval()
        net.load_state_dict(state)
        return net

    model = trained(run_cfg.TPU.COMPUTE_DTYPE)
    tcfg = TransformConfig.test_from_cfg(run_cfg)
    test_recs = load_voc_split(devkit, "2007", "test", None, keep_empty=True)
    test_images = [load_image_bgr(r["file_name"]) for r in test_recs]

    # (a) proposals an image at test settings, trained and random weights
    def proposals(net):
        kept = []
        for img in test_images:
            s = prepare_test_image(img, tcfg)
            with torch.inference_mode():
                _, _, props, _ = net.predict_raw(
                    torch.as_tensor(s["image"][None], device=dev),
                    torch.as_tensor(s["image_size"][None], device=dev))
            kept.append(int(props.valid.sum()))
        return kept

    kept_trained = proposals(model)
    random_model = flagship_model(run_cfg, seed, dev)
    kept_random = proposals(random_model)
    del random_model
    free()
    cap = run_cfg.MODEL.RPN.POST_NMS_TOPK_TEST
    log(f"[19] (a) RPN proposals kept an image at test settings ({run_cfg.MODEL.RPN.PRE_NMS_TOPK_TEST}"
        f" -> {cap} at IoU {run_cfg.MODEL.RPN.NMS_THRESH}), over the {len(test_images)} test "
        f"images: trained mean {np.mean(kept_trained):.1f} (min {min(kept_trained)}, max "
        f"{max(kept_trained)}); random weights with calibrated FrozenBN mean "
        f"{np.mean(kept_random):.1f} (min {min(kept_random)}, max {max(kept_random)})")

    # (d) bf16 against f32 on the test images, as served
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = trained("float32")
    svc, svc32 = (DetectionService(run_cfg, m, class_names=VOC_CLASSES)
                  for m in (model, model32))
    dets_bf16 = [svc.detect_array(img) for img in test_images]
    dets_f32 = [svc32.detect_array(img) for img in test_images]
    del svc, svc32
    same = [match_detections(g, w, BATCH_BOX_ATOL, BATCH_BOX_RTOL, BATCH_SCORE_ATOL,
                             BATCH_SCORE_RTOL) for g, w in zip(dets_bf16, dets_f32)]
    log(f"[19] (d) bf16 against f32 on the same {len(test_images)} requests (reported, not "
        f"gated): {sum(s[0] for s in same)} within the f32 bounds (boxes "
        f"{BATCH_BOX_ATOL} px + {BATCH_BOX_RTOL}, scores {BATCH_SCORE_ATOL} + "
        f"{BATCH_SCORE_RTOL}), detections {sum(map(len, dets_bf16))} vs "
        f"{sum(map(len, dets_f32))}, max |box diff| {max(s[1] for s in same):.4g} px, max "
        f"|score diff| {max(s[2] for s in same):.4g}")

    # (c) the f32 predict and train paths, kernels vs plain, on trained weights
    torch.backends.cudnn.deterministic = True
    s = prepare_test_image(test_images[0], tcfg)
    predict_path_kernels_vs_plain(model32, torch.as_tensor(s["image"][None], device=dev),
                                  torch.as_tensor(s["image_size"][None], device=dev), "[19] (c)")
    step_cfg = cfg.clone()  # the recipe's own solver: FREEZE_AT 2, its LR
    step_cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    step_cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    step_cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    strong, weak = shapes_voc_step_batches(devkit, step_cfg, TRAINED_STEP_SIZE)
    build_optimizer(step_cfg, model32)
    strong_t = {k: torch.as_tensor(v, device=dev) for k, v in strong.items()}
    weak_t = {k: torch.as_tensor(v, device=dev) for k, v in weak.items()}
    train_path_kernels_vs_plain(model32, strong_t, weak_t, seed, "[19] (c)")
    del model32, strong_t, weak_t
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    free()

    # (e) a trained step under the recipe's solver, its K3 input kept (b)
    solver = build_optimizer(step_cfg, model)
    model.train()
    step_trainer = TrainerNoMeta(model, solver, itertools.repeat(strong), itertools.repeat(weak),
                                 seed=seed)
    step_trainer.init_state()
    k3_in = []
    real_k3 = nms_ops.nms_sorted_mask_cuda

    def record_k3(boxes, thr, cap=None, n_valid=None):
        k3_in.append((boxes.clone(), thr, cap, None if n_valid is None else n_valid.clone()))
        return real_k3(boxes, thr, cap, n_valid=n_valid)

    nms_ops.nms_sorted_mask_cuda = record_k3
    try:
        step_trainer.run_step()  # a warm-up, its K3 input kept
    finally:
        nms_ops.nms_sorted_mask_cuda = real_k3
    reset_launch_counts()
    m = step_trainer.run_step().resolve()
    launches = read_launch_counts()
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)
    want = {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1, "nms_mask_images": 4,
            "bn_act_fwd": n_backbone + 3 * n_res5, "bn_act_bwd": n_trainable + 2 * n_res5,
            "bn_act_layout_copies": 2}
    log(f"[19] (e) a trained step of 2 + 2 images at {strong['image'].shape[1]}x"
        f"{strong['image'].shape[2]} under the recipe's solver: "
        + ", ".join(f"{k} {v:.4g}" for k, v in m.items() if k != "data_time")
        + f"; launches {launches} (want {want})")
    if on_card and launches != want:
        raise AssertionError(f"a trained step's launches {launches}, want {want}")
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"a trained step without finite losses: {m}")
    by_path["trained_step"] = launches
    del step_trainer, solver, model
    free()

    # (b) K3 at the trained RPN's own train-step input, beside phase 3's layouts
    k3_trained = {}
    if on_card:
        (sb, thr, cap, n_valid), = k3_in  # one selection for the step's 4 images
        got = real_k3(sb, thr, cap, n_valid=n_valid)
        same = torch.equal(got, real_k3(sb, thr, cap, n_valid=n_valid))
        plain = nms_ops.nms_sorted_mask_plain(sb, thr, cap)
        q_ms, _ = cuda_ms_queued(lambda: real_k3(sb, thr, cap, n_valid=n_valid), 20)
        p_ms = cuda_ms(lambda: nms_ops.nms_sorted_mask_plain(sb, thr, cap), 2)
        walked = nms_rows_walked(got, cap, n_valid)
        least = bound(nms_bytes(sb, got, cap, n_valid),
                      nms_pair_tests(got, cap, n_valid) * IOU_FLOPS)
        log(f"[19] (b) K3 at the trained RPN's train-step input {list(sb.shape)} -> {cap} at "
            f"IoU {thr}, valid {n_valid.tolist() if n_valid is not None else 'all'}: keeps "
            f"{got.sum(-1).tolist()}, rows walked {walked}, {int((got != plain).sum())} rows "
            f"differ from the plain version, two launches bit-identical {same}; kernel "
            f"{q_ms:.4f} ms queued, plain {p_ms:.4f} ms, bound {least['bound_ms']:.5f} ms by "
            f"{least['bound_by']}")
        if not (torch.equal(got, plain) and same):
            raise AssertionError("K3 at the trained RPN's input differs from its plain version")
        layouts = {}
        for name, batch in nms_train_layouts(np.random.RandomState(seed + 19)).items():
            lb = torch.as_tensor(batch, device=dev)
            keep = real_k3(lb, 0.7, 2000)
            layouts[name] = (cuda_ms_queued(lambda: real_k3(lb, 0.7, 2000), 20)[0],
                             nms_rows_walked(keep, 2000))
        nearest = min(layouts, key=lambda k: abs(np.log(layouts[k][0] / q_ms)))
        log(f"[19] (b) the synthetic layouts in this call, queued ms and rows walked: "
            + "; ".join(f"{k} {v[0]:.4f}, {v[1]}" for k, v in layouts.items())
            + f"; the trained input's time is nearest the {nearest} layout's")
        k3_trained = {"trained_train_ms": q_ms, "trained_train_plain_ms": p_ms,
                      "trained_train_bound_ms": least["bound_ms"],
                      "trained_train_keeps": got.sum(-1).tolist(),
                      "trained_train_rows_walked": walked,
                      "trained_train_nearest_layout": nearest,
                      **{f"layout_{k}_queued_ms": v[0] for k, v in layouts.items()}}
    del k3_in[:]
    free()
    log(f"[19] phase 19 in {time.perf_counter() - t_phase:.1f} s")
    return by_path, k3_trained


HOST_WIRE_SHAPES = ((375, 500), (500, 375))   # (h, w): VOC's two common sizes
HOST_WIRE_IMAGES = 8       # JPEGs of each shape: prepare_batch's batch and threads
HOST_WIRE_TIMED = 5        # host ms an image: the median of this many images
HOST_WIRE_RUN_SHAPES = ((375, 500), (333, 500))  # landscape only: one canvas a step
HOST_WIRE_STEPS = 12       # run-loop steps through each decode path
HOST_WIRE_REQUESTS = 16
HOST_WIRE_UPLOADS = 10     # uploads timed a wire (median)
C_VS_NUMPY_ATOL = 2.0 ** -8  # the C resize in f32 against the numpy one in f64


def phase_host_wire(cfg, seed, workdir):
    """Phase 20: the host wire.  (a) build the C host loader
    (csrc/dataloader.cc, g++) and print how it decodes; (b) prepare_image,
    prepare_image_mem and prepare_batch (several threads) bit-identical on
    VOC-sized JPEGs, and the C canvas within C_VS_NUMPY_ATOL of the numpy
    path's with equal dims and scale; (c) host ms an image, C against PIL +
    numpy, and a threaded batch; (d) engine.runner.run at full width on a
    devkit of JPEG files (no image_loader) through the C loader at
    metrics_pipeline_depth 0 and 8 in turns (``depth_turns``), then the same
    steps through PIL (the script patches data.native.available): windowed
    step time, data wait and each step's launches; (e) detect_bytes on JPEGs at batch 1
    and micro-batched at 4 under 8 clients, C against PIL: req/s, p50, images
    a device call; (f) TPU.HOST_TRANSFER_UINT8: served batch-4 requests and
    train steps on uint8 batches, upload bytes and ms against the f32 wire,
    finite losses, unchanged launches.  Returns {path: launch counts}."""
    import runpy

    import torch

    from unit_tpu_torch.checkpoint import Checkpointer
    from unit_tpu_torch.data import DatasetCatalog, native
    from unit_tpu_torch.data.loader import pin_batch
    from unit_tpu_torch.data.transforms import (TransformConfig, load_image_bgr,
                                                oriented_canvas, prepare_test_image)
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.predict import upload_image
    from unit_tpu_torch.engine.train import TrainerNoMeta, TrainState
    from unit_tpu_torch.models.similarity import VOC_CLASSES
    from unit_tpu_torch.serving import DetectionService
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def median_ms(fn, n):
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    cfg = cfg.clone()
    cfg.merge_from_list(list(RUN_EXTRA_OPTS))
    by_path = {}

    # (a) the build
    lib = native.load_library()
    st = native.STATUS
    if lib is None:
        raise AssertionError(f"the host loader did not build: {st['error']}")
    log(f"[20] (a) host loader csrc/dataloader.cc built ({st['seconds']:.2f} s of g++, 0 if "
        f"built before) at {os.path.relpath(st['path'], ROOT)}; JPEG decode: {st['decode']}"
        + ("" if st["decode"] == "libjpeg" else " (no jpeglib.h here: PIL decodes, C resizes)"))

    # (b) the three entry points agree bit for bit, and the C canvas with numpy's
    rng = np.random.RandomState(seed + 200)
    jdir = os.path.join(workdir, "host_wire_jpegs")
    os.makedirs(jdir, exist_ok=True)
    files = {shape: [write_jpeg(os.path.join(jdir, f"{shape[0]}x{shape[1]}_{i}.jpg"),
                                natural_image(rng, *shape)) for i in range(HOST_WIRE_IMAGES)]
             for shape in HOST_WIRE_SHAPES}
    tcfg = TransformConfig.test_from_cfg(cfg)
    ms_, mx_ = tcfg.min_sizes[0], tcfg.max_size
    identical, worst, dims_ok = True, 0.0, True
    for shape, paths in files.items():
        canvas = oriented_canvas(*shape, tcfg.canvas)
        images, sizes, scales = native.prepare_batch_native(paths, ms_, mx_, canvas,
                                                            n_threads=HOST_WIRE_IMAGES)
        for i, path in enumerate(paths):
            data = Path(path).read_bytes()
            for flip in (False, True):
                one = native.prepare_image_native(path, ms_, mx_, canvas, flip)
                mem = native.prepare_image_mem_native(data, ms_, mx_, canvas, flip)
                identical &= (np.array_equal(one[0], mem[0]) and one[1:] == mem[1:3]
                              and mem[3] == shape)
                if not flip:
                    identical &= (np.array_equal(images[i], one[0])
                                  and tuple(sizes[i].astype(int)) == one[1]
                                  and float(scales[i]) == one[2])
        s = prepare_test_image(load_image_bgr(paths[0]), tcfg)
        img, (nh, nw), scale = native.prepare_image_native(paths[0], ms_, mx_, canvas)
        dims_ok &= ((nh, nw) == tuple(s["image_size"].astype(int))
                    and np.float32(scale) == s["scale"] and img.shape == s["image"].shape)
        worst = max(worst, float(np.abs(img - s["image"]).max()))
    log(f"[20] (b) {len(HOST_WIRE_SHAPES) * HOST_WIRE_IMAGES} JPEGs of {HOST_WIRE_SHAPES} at "
        f"{ms_}/{mx_}: prepare_image = prepare_image_mem (flip on and off) = prepare_batch "
        f"({HOST_WIRE_IMAGES} threads) bit for bit {identical}; against the numpy path: dims and "
        f"scale equal {dims_ok}, max |diff| {worst:.3g} (tol {C_VS_NUMPY_ATOL:.3g})")
    if not (identical and dims_ok and worst <= C_VS_NUMPY_ATOL):
        raise AssertionError("the C loader's entry points disagree, or its canvas is off the "
                             "numpy path's")

    # (c) host ms an image, C against PIL + numpy
    host = {}
    for shape, paths in files.items():
        canvas = oriented_canvas(*shape, tcfg.canvas)
        for name, fn in (("C", lambda p: native.prepare_image_native(p, ms_, mx_, canvas)),
                         ("PIL+numpy", lambda p: prepare_test_image(load_image_bgr(p), tcfg))):
            times = []
            for p in paths[:HOST_WIRE_TIMED]:
                t = time.perf_counter()
                fn(p)
                times.append((time.perf_counter() - t) * 1e3)
            host[f"{shape[0]}x{shape[1]} {name}"] = float(np.median(times))
    land = files[HOST_WIRE_SHAPES[0]]
    canvas = oriented_canvas(*HOST_WIRE_SHAPES[0], tcfg.canvas)
    batch_ms = median_ms(lambda: native.prepare_batch_native(land, ms_, mx_, canvas,
                                                             n_threads=HOST_WIRE_IMAGES), 3)
    log(f"[20] (c) host ms an image to the {tcfg.canvas} canvases (median of "
        f"{HOST_WIRE_TIMED}, decode {st['decode']}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
        + f"; prepare_batch of {HOST_WIRE_IMAGES} on {HOST_WIRE_IMAGES} threads "
        f"{batch_ms:.2f} ms ({batch_ms / HOST_WIRE_IMAGES:.2f} an image), {os.cpu_count()} cores")

    # (d) the run loop on JPEG files, through C, then through PIL
    devkit = write_devkit(os.path.join(workdir, "VOCdevkit_jpeg"), seed,
                          shapes=HOST_WIRE_RUN_SHAPES, jpegs=True)
    model = flagship_model(cfg, seed, dev)
    init = Checkpointer(os.path.join(workdir, "host_wire_init")).save(
        0, TrainState(model, build_optimizer(cfg, model), 0), wait=True)
    made = []
    Recording = loop_recording(made)

    def run_loop(path, turn=""):
        DatasetCatalog.clear()
        made.clear()
        args = runner.default_argument_parser().parse_args([
            "--config-file", str(FLAGSHIP), "--data-root", devkit, "--device", RUN_DEVICE,
            "MODEL.WEIGHTS", init,
            "OUTPUT_DIR", os.path.join(workdir, f"host_wire_{path}{turn}"),
            "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
            "DATASETS.CLASSIFIER_DATAROOT", devkit, "SEED", str(seed),
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(HOST_WIRE_STEPS),
            "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0",
            "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
            *RUN_EXTRA_OPTS])
        calls = count_calls(native, "prepare_image_native")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            results = runner.run(args)  # no image_loader: the devkit's JPEG files
        finally:
            native.prepare_image_native = calls["real"]
        secs = time.perf_counter() - t
        trainer = made[-1]
        n_backbone, n_res5, n_trainable = frozen_bn_counts(trainer.model)
        want = {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1, "nms_mask_images": 4,
                "bn_act_fwd": n_backbone + 3 * n_res5, "bn_act_bwd": n_trainable + 2 * n_res5,
                "bn_act_layout_copies": 2}
        total = {k: sum(c[k] for c in trainer.launches) for k in want}
        finite = all(np.isfinite(v) for m in trainer.metrics_history for v in m.values())
        out = loop_turn(trainer, dict(enumerate(trainer.metrics_history, 1)), secs, dev)
        evaluated = "bbox" in results  # the turns leave the final evaluation out
        ap50 = results["bbox"]["AP50"] if evaluated else float("nan")
        log(f"[20] (d) run loop through {path}{turn}: {HOST_WIRE_STEPS} steps"
            + (f" and the final evaluation of {RUN_TEST_IMAGES} images" if evaluated else "")
            + f" in {secs:.1f} s ({calls['n']} C calls), "
            f"metrics_pipeline_depth {out['depth']}: the last {len(out['waits'])} steps and "
            f"the drain {out['ms']:.2f} ms a step ({4e3 / out['ms']:.2f} images/s), data wait "
            f"median {np.median(out['waits']):.2f} ms (max {max(out['waits']):.2f}); AP50 "
            f"{ap50:.4g}; launches a step {trainer.launches[-1]}")
        if on_card and any(c != want for c in trainer.launches):
            raise AssertionError(f"a run-loop step through {path} did not launch {want}: "
                                 f"{trainer.launches}")
        if not finite or (evaluated and not np.isfinite(ap50)) \
                or (calls["n"] > 0) != (path == "C"):
            raise AssertionError(f"the run through {path} has a non-finite result or took "
                                 "the other decode path")
        by_path[f"host_wire_run_{path}"] = total
        del trainer
        made.clear()
        return out

    real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
    real_available = native.available
    try:
        turns = []  # through C at each depth of the deferred loss fetch, in turns
        for i, depth in enumerate(DEPTH_TURNS):
            Recording.depth, Recording.profile_last = depth, PROFILED_STEPS * (i >= 2)
            with no_final_evaluation(runner):
                turns.append(run_loop("C", f" (turn {i + 1})"))
        ms = depth_turns("[20] (d) through C:", turns, HOST_WIRE_STEPS, 4)
        Recording.depth, Recording.profile_last = max(DEPTH_TURNS), 0
        loop = {"C": {"step_ms": ms[max(DEPTH_TURNS)],
                      "wait_ms": float(np.median([w for t in turns for w in t["waits"]]))}}
        native.available = lambda: False  # the script's switch: the PIL path
        pil = run_loop("PIL")
        loop["PIL"] = {"step_ms": pil["ms"], "wait_ms": float(np.median(pil["waits"]))}
    finally:
        native.available = real_available
        runner.TrainerNoMeta = real_trainer
    if on_card:
        torch.cuda.empty_cache()
    log(f"[20] (d) run loop at depth {max(DEPTH_TURNS)}, C against PIL in one call: windowed "
        f"step {loop['C']['step_ms']:.2f} vs {loop['PIL']['step_ms']:.2f} ms, data wait "
        f"{loop['C']['wait_ms']:.2f} vs {loop['PIL']['wait_ms']:.2f} ms")

    # (e) detect_bytes on JPEGs, C against PIL, batch 1 and micro-batched
    bench = runpy.run_path(str(ROOT / "scripts" / "bench_serving_torch.py"))
    jpegs = [Path(files[HOST_WIRE_SHAPES[i % 2]][(i // 2) % HOST_WIRE_IMAGES]).read_bytes()
             for i in range(HOST_WIRE_REQUESTS)]
    n_backbone, n_res5, _ = frozen_bn_counts(model)
    k4_call = n_backbone + (2 if model.mc.multi_box_head else 1) * n_res5

    def want_launches(calls):
        return {"roi_align_fwd": len(calls), "roi_align_bwd": 0,
                "nms_mask": sum(1 + b for b in calls), "nms_mask_images": sum(2 * b for b in calls),
                "bn_act_fwd": k4_call * len(calls), "bn_act_bwd": 0, "bn_act_layout_copies": 0}

    def serve(svc, path):
        calls = []
        owner = svc if svc._batcher is None else svc._batcher
        inner = owner._predict

        def counted(images, sizes):
            calls.append(images.shape[0])
            return inner(images, sizes)

        owner._predict = counted
        bench["run"](svc, jpegs[: SERVE_CLIENTS], SERVE_CLIENTS, "bytes")  # warm
        calls.clear()
        reset_launch_counts()
        rps, p50, p99, _, results = bench["run"](svc, jpegs, SERVE_CLIENTS, "bytes")
        launches = read_launch_counts()
        for i, dets in enumerate(results):
            h, w = HOST_WIRE_SHAPES[i % 2]
            for d in dets:
                x1, y1, x2, y2 = d["box"]
                if not (np.isfinite(d["box"]).all() and 0 <= x1 <= x2 <= w
                        and 0 <= y1 <= y2 <= h and 0 < d["score"] <= 1):
                    raise AssertionError(f"a served detection outside the image or range: {d}")
        if on_card and launches != want_launches(calls):
            raise AssertionError(f"the served calls {calls} through {path} did not launch "
                                 f"{want_launches(calls)}: {launches}")
        return {"rps": rps, "p50": p50, "p99": p99, "calls": calls}, launches

    served = {}
    for batch in (1, SERVE_BATCH):
        for path in ("C", "PIL"):
            svc = DetectionService(cfg, model, class_names=VOC_CLASSES, batch_size=batch,
                                   batch_wait_ms=SERVE_WAIT_MS)
            svc.warmup()
            if path == "PIL":
                native.available = lambda: False
            try:
                served[batch, path], launches = serve(svc, path)
            finally:
                native.available = real_available
                svc.close()
            if batch > 1:
                by_path[f"host_wire_serving_{path}"] = launches
            r = served[batch, path]
            log(f"[20] (e) detect_bytes, batch {batch}, {SERVE_CLIENTS} clients, "
                f"{HOST_WIRE_REQUESTS} JPEGs of {HOST_WIRE_SHAPES} through {path}: "
                f"{r['rps']:.2f} req/s, p50 {r['p50']:.1f} ms, p99 {r['p99']:.1f} ms, "
                f"{len(r['calls'])} device calls, {np.mean(r['calls']):.2f} images a call")

    # (f) the uint8 wire: served batch-4 requests and train steps
    cfg8 = cfg.clone()
    cfg8.TPU.HOST_TRANSFER_UINT8 = True
    svc = DetectionService(cfg8, model, class_names=VOC_CLASSES, batch_size=SERVE_BATCH,
                           batch_wait_ms=SERVE_WAIT_MS)
    dtypes = []
    inner_predict = svc._batcher._predict
    svc._batcher._predict = lambda i, s: (dtypes.append(i.dtype), inner_predict(i, s))[1]
    svc.warmup()
    try:
        u8, launches = serve(svc, "C, uint8 wire")
    finally:
        svc.close()
    by_path["host_wire_uint8_serving"] = launches
    if set(dtypes) != {np.dtype(np.uint8)}:
        raise AssertionError(f"the uint8 wire submitted {set(dtypes)}")
    f32 = np.random.RandomState(seed + 201).uniform(
        0, 255, (SERVE_BATCH,) + tcfg.canvas + (3,)).astype(np.float32)
    wires = {"f32": f32, "uint8": np.clip(np.rint(f32), 0, 255).astype(np.uint8)}
    up = {k: [] for k in wires}
    for k in ("f32", "uint8", "uint8", "f32"):  # in turns
        up[k].append(median_ms(lambda: upload_image(wires[k], dev), HOST_WIRE_UPLOADS))
    log(f"[20] (f) served batch {SERVE_BATCH} on the uint8 wire: {u8['rps']:.2f} req/s (f32 "
        f"wire {served[SERVE_BATCH, 'C']['rps']:.2f}), p50 {u8['p50']:.1f} ms, "
        f"{np.mean(u8['calls']):.2f} images a call, launches {launches}; a call's canvases "
        f"{wires['uint8'].nbytes / 2**20:.2f} MiB against {f32.nbytes / 2**20:.2f}, pageable "
        f"upload ms in turns: uint8 {up['uint8']}, f32 {up['f32']}")

    cfg_train = cfg.clone()
    cfg_train.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg_train.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    strong, weak = synthetic_train_batches(cfg_train, seed, n_batches=2)
    for b in strong + weak:
        b["image"] = np.clip(np.rint(b["image"]), 0, 255).astype(np.uint8)
    f32_strong = [dict(b, image=b["image"].astype(np.float32)) for b in strong]
    if on_card:  # as the runner's Prefetcher hands them out
        strong, weak, f32_strong = ([pin_batch(b) for b in s] for s in (strong, weak, f32_strong))
    trainer = TrainerNoMeta(model, build_optimizer(cfg_train, model), itertools.cycle(strong),
                            itertools.cycle(weak), seed=seed)
    trainer.init_state()
    trainer.run_step()  # warm-up
    sync()
    reset_launch_counts()
    t = time.perf_counter()
    metrics = [trainer.run_step() for _ in range(2)]
    trainer.drain()  # the window ends in the drain: the clock holds the device's time
    step_ms = (time.perf_counter() - t) * 1e3 / 2
    launches = read_launch_counts()
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)
    want = {"roi_align_fwd": 4, "roi_align_bwd": 4, "nms_mask": 2, "nms_mask_images": 8,
            "bn_act_fwd": 2 * (n_backbone + 3 * n_res5),
            "bn_act_bwd": 2 * (n_trainable + 2 * n_res5), "bn_act_layout_copies": 4}
    up_t = {k: [] for k in ("f32", "uint8")}
    for k in ("f32", "uint8", "uint8", "f32"):
        b = f32_strong[0] if k == "f32" else strong[0]
        up_t[k].append(median_ms(lambda: trainer._to_device(b), HOST_WIRE_UPLOADS))
    finite = all(np.isfinite(v) for m in metrics for v in m.values())
    log(f"[20] (f) 2 flagship train steps on uint8 batches: {step_ms:.2f} ms a step, losses "
        + ", ".join(f"{k} {v:.4g}" for k, v in metrics[-1].items() if k != "data_time")
        + f"; launches {launches}; a strong batch's images "
        f"{np.asarray(strong[0]['image']).nbytes / 2**20:.2f} MiB against "
        f"{np.asarray(f32_strong[0]['image']).nbytes / 2**20:.2f}, "
        f"{'pinned' if on_card else 'pageable'} upload ms in turns: uint8 {up_t['uint8']}, "
        f"f32 {up_t['f32']}")
    if not finite:
        raise AssertionError(f"a non-finite loss on the uint8 wire: {metrics}")
    if on_card and launches != want:
        raise AssertionError(f"the uint8 train steps did not launch {want}: {launches}")
    by_path["host_wire_uint8_train"] = launches
    del trainer, model
    if on_card:
        torch.cuda.empty_cache()
    log(f"[20] phase 20 in {time.perf_counter() - t_phase:.1f} s")
    return by_path


# Phase 21: data parallelism on one card.  NCCL refuses two ranks on one
# device, so the two ranks of (a)-(c) share card 0 over gloo (its all-reduce
# of CUDA tensors goes through the host), and (d) runs one rank over NCCL
# through --dist.  No NCCL figure at world >= 2 can be taken here.
# Phase 23: the pairings a shipped recipe reaches with two keys changed, at
# full width: the note with masks, the note and the dock with the meta stream.
PAIR_MASK_KEYS = ("MODEL.MASK_ON", "True", "MODEL.ROI_HEADS.NAME", "WSROIHeadNoMetaWithMask")
PAIR_META_KEYS = ("MODEL.META_ARCHITECTURE", "WeaklySupervisedRCNN",
                  "MODEL.ROI_HEADS.NAME", "WSROIHead")
PAIR_REQUESTS = 2
PAIR_TRAIN_STEPS = 2       # timed steps after TRAIN_WARMUP, a path
PAIR_SUPPORT_SHOTS = 2     # BASE_META_SHOTS of meta_attention over a registered support set
PAIR_DOCK_CANVASES = TRAIN_CANVASES  # the dock's 800-pixel short side, both orientations


def phase_pairs(seed, workdir):
    """Phase 23: the pairings a shipped recipe reaches with two keys changed,
    at full width and depth, seeded weights, bf16.  (a) the note recipe with
    MODEL.MASK_ON and WSROIHeadNoMetaWithMask (the mask head over the
    InceptionResNetV2 tail's [N, 8, 8, 1536] map: 16 x 16 masks): requests
    (K1 x2, K3 x2, no K4), K1 at the mask path's own input ([1, h, w, 1088] x
    100 final boxes at P = 17), the f32 predict with masks kernels vs plain,
    TrainerNoMeta steps of 2 + 2 images with gt_masks (K1 2, K2 2, K3 1), K2
    at the step's own gradients, the f32 train path kernels vs plain,
    engine.runner.run on phase 12's shapes-COCO devkit (2 steps and the
    bbox and segm evaluation); (b) the
    note with the meta architecture and WSROIHead: Trainer steps with the
    recipe's support batch (20 classes x 10 shots at 224; K1 3: the shots
    at P = 17 over 1088 channels; K2 2; K3 1; K4 in the meta Res5 over the
    shots and the query slots, forward and backward), K1 at the step's
    shots, K4 at the meta head's shapes, meta_attention over the registered
    coco_note_base_training_support; (c) the dock recipe with the same two
    keys and precomputed proposals for both streams: Trainer steps (the
    shots' K1 at P = 6 over VGG-CNN-F's 256 channels, the dock's first K1
    launches; no RPN, no K2; K4 in the meta Res5, 6 x 6 -> 3 x 3), K1 at the
    step's shots, K4 at the meta head's shapes, meta_attention over
    coco_dock_base_training_support.  Returns ({path: launch counts}, K1's,
    K2's and K4's numbers at the new shapes)."""
    import runpy

    import torch

    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.data.loader import pin_batch
    from unit_tpu_torch.data.transforms import TransformConfig, prepare_test_image
    from unit_tpu_torch.data.utils import register_datasets
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import Trainer, TrainerNoMeta
    from unit_tpu_torch.models.resnet import FrozenBN
    from unit_tpu_torch.models.similarity import COCO_CLASSES
    from unit_tpu_torch.ops import roi_align as ra
    from unit_tpu_torch.serving import DetectionService
    from unit_tpu_torch.solver import build_optimizer

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    by_path, k1_out, k2_out, k4_out, wrong = {}, {}, {}, {}, []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_mib():
        return torch.cuda.max_memory_allocated() / 2**20 if on_card else 0.0

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def free():
        if on_card:
            torch.cuda.empty_cache()

    def expect(path, got, want):
        """Launches a step (or a request) of ``path`` against ``want``; every
        mismatch of the phase is reported at its end."""
        ok = all(got[k] == want[k] for k in want)
        log(f"[23] {path}: launches as expected {ok}")
        if on_card and not ok:
            wrong.append(f"{path}: {got}, want {want}")

    def recipe(path, *keys):
        cfg = get_cfg()
        cfg.merge_from_file(str(path))
        cfg.merge_from_list(list(keys) + list(RUN_EXTRA_OPTS))
        cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True  # random weights: clipped as in phase 7
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
        return cfg

    def steps(trainer, tag, n):
        times = []
        for _ in range(n):
            t = time.perf_counter()
            m = trainer.run_step().resolve()  # read now: the clock holds the device's time
            times.append((time.perf_counter() - t) * 1e3)
            log(f"{tag} step {trainer.state.step} {times[-1]:.1f} ms: " + ", ".join(
                    f"{k} {v:.4g}" for k, v in m.items() if k != "data_time"))
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"{tag} a step without finite losses: {m}")
        return times

    real_k1, real_k2 = ra.roi_align_cuda, ra.roi_align_backward_cuda
    k1_in, k2_in = [], []

    def record_k1(feats, rois, *a):
        k1_in.append((feats.detach().clone(), rois.clone(), a))
        return real_k1(feats, rois, *a)

    def record_k2(g, rois, shape, *a):
        k2_in.append((g.clone(), rois.clone(), tuple(shape), a))
        return real_k2(g, rois, shape, *a)

    root = os.path.join(workdir, "shapes_coco")  # phase 12's devkit
    if not os.path.isdir(root):
        runpy.run_path(str(ROOT / "scripts" / "make_shapes_coco_torch.py"))[
            "write_shapes_coco"](root, COCO_TRAIN_IMAGES, COCO_VAL_IMAGES, COCO_IMAGE_SIZE, seed)
    for src, dst in (("val2017", "val2014"),  # the dock suite's 2014 names
                     (os.path.join("annotations", "instances_val2017.json"),
                      os.path.join("annotations", "instances_val2014.json"))):
        if not os.path.exists(os.path.join(root, dst)):
            os.symlink(os.path.basename(src), os.path.join(root, dst))

    # (a) the note with masks: requests
    cfg = recipe(NOTE_RECIPE, *PAIR_MASK_KEYS)
    # random heads spread their probability over 81 classes and few scores
    # pass the recipe's 0.05: phase 12's threshold, so that masks are served
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.01
    model = flagship_model(cfg, seed, dev)  # no FrozenBN anywhere: nothing to calibrate
    mc = model.mc
    p = mc.pooler_resolution
    log(f"[23] (a) note + masks: {type(model.backbone).__name__} + "
        f"{type(model.box_head).__name__} ({model.box_head.out_channels}-d map) + the mask head "
        f"over it, {sum(q.numel() for q in model.parameters()) / 1e6:.1f} M params, P = {p}, "
        f"{mc.num_classes} classes, compute {mc.compute_dtype}")
    svc = DetectionService(cfg, model, class_names=COCO_CLASSES)
    svc.warmup()
    sync()
    rng = np.random.RandomState(seed + 230)
    images = [rng.uniform(0, 255, NOTE_REQUEST_SHAPES[i % 2] + (3,)).astype(np.float32)
              for i in range(PAIR_REQUESTS)]
    reset_peak()
    reset_launch_counts()
    lat, results = [], []
    for img in images:
        t0 = time.perf_counter()
        results.append(svc.detect_array(img))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = read_launch_counts()
    log(f"[23] (a) {PAIR_REQUESTS} requests with masks, latency ms "
        f"{[round(v, 2) for v in lat]}, peak device memory {peak_mib():.1f} MiB; detections "
        f"{[len(r) for r in results]}; launches {launches} (want K1 x2, K3 x2, no K4 each)")
    expect("note_masks_serving", launches,
           {"roi_align_fwd": 2 * PAIR_REQUESTS, "roi_align_bwd": 0,
            "nms_mask": 2 * PAIR_REQUESTS, "nms_mask_images": 2 * PAIR_REQUESTS,
            "bn_act_fwd": 0, "bn_act_bwd": 0})
    by_path["note_masks_serving"] = launches
    for img, dets in zip(images, results):
        h, w = img.shape[:2]
        for d in dets:
            x1, y1, x2, y2 = d["box"]
            if not (np.isfinite(d["box"]).all() and 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
                    and 0 < d["score"] <= 1 and 0 <= d["class_id"] < mc.num_classes):
                raise AssertionError(f"a detection outside the image or range: {d}")
    s = prepare_test_image(images[0], svc.tcfg)
    img = torch.as_tensor(s["image"][None], device=dev)
    size = torch.as_tensor(s["image_size"][None], device=dev)
    with torch.inference_mode():
        feats = model.predict_raw(img, size)[3]
        dets = model.predict(img, size)
    masks_ok = bool(torch.isfinite(dets.masks).all() and dets.masks.min() >= 0
                    and dets.masks.max() <= 1)
    log(f"[23] (a) one request's masks {tuple(dets.masks.shape)} (16 x 16 from the tail's "
        f"8 x 8 map), in [0, 1] and finite {masks_ok}; {int(dets.valid.sum())} valid of "
        f"{dets.boxes.shape[1]}")
    if not (masks_ok and tuple(dets.masks.shape[2:]) == (16, 16)):
        raise AssertionError("the note's masks are not 16 x 16 probabilities")
    if on_card:
        boxes = dets.boxes.float().contiguous()
        label = f"note mask path {list(feats.shape)} x {boxes.shape[1]} final boxes P={p}"
        err = k1_check(feats, boxes, label, tag="[23]", p=p)
        k_ms, p_ms, least = k1_timed(feats, boxes, label, tag="[23]", p=p)
        k1_out.update({"note_mask_path_ms": k_ms, "note_mask_path_plain_ms": p_ms,
                       "note_mask_path_bound_ms": least["bound_ms"],
                       "note_mask_path_max_abs_err": err,
                       "note_mask_path_shape": list(feats.shape) + [boxes.shape[1], p]})
        profile_run(lambda: svc.detect_array(images[0]), "[23]", "note request with masks",
                    top=10)
    del svc, model, feats, dets
    free()

    # the f32 predict with masks, kernels vs plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = flagship_model(cfg32, seed, dev)
    s = prepare_test_image(images[1], TransformConfig.test_from_cfg(cfg32))
    img = torch.as_tensor(s["image"][None], device=dev)
    size = torch.as_tensor(s["image_size"][None], device=dev)
    outs = {}
    for impl in ("cuda", "plain"):
        model32.mc = dataclasses.replace(model32.mc, roi_align_impl=impl, nms_impl=impl)
        with torch.inference_mode():
            outs[impl] = model32.predict(img, size)
    dk, dp = outs["cuda"], outs["plain"]
    same = torch.equal(dk.classes, dp.classes) and torch.equal(dk.valid, dp.valid)
    dbox = float((dk.boxes - dp.boxes).abs().max())
    dscore = float((dk.scores - dp.scores).abs().max())
    dmask = float((dk.masks - dp.masks).abs().max())
    log(f"[23] (a) f32, TF32 off, predict with masks: classes and valid identical {same} "
        f"({int(dk.valid.sum())} valid); boxes max|diff| {dbox:.3g} px (tol {MASK_BOX_ATOL}), "
        f"scores {dscore:.3g}, mask probabilities {dmask:.3g} (tol {MASK_PROBS_ATOL})")
    if not (same and int(dk.valid.sum()) > 0 and dbox <= MASK_BOX_ATOL
            and dscore <= MASK_PROBS_ATOL and dmask <= MASK_PROBS_ATOL):
        raise AssertionError("the note's predict with masks disagrees with the plain path")
    del model32, outs, dk, dp

    # the f32 train path with gt_masks, kernels vs plain versions
    model32 = flagship_model(cfg32, seed, dev)
    build_optimizer(cfg32, model32)
    strong, weak = synthetic_train_batches(cfg32, seed + 231, n_batches=1,
                                           canvases=NOTE_CANVASES)
    strong = {k: torch.as_tensor(v, device=dev) for k, v in strong[0].items()}
    weak = {k: torch.as_tensor(v, device=dev) for k, v in weak[0].items()}
    train_path_kernels_vs_plain(model32, strong, weak, seed, "[23] (a)")
    del model32, strong, weak
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    free()

    # train steps with gt_masks: 2 + 2 images, the warm-up's K2 inputs kept
    model = flagship_model(cfg, seed, dev)
    solver = build_optimizer(cfg, model)
    strong, weak = synthetic_train_batches(cfg, seed + 232, canvases=NOTE_CANVASES)
    trainer = TrainerNoMeta(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                            seed=seed)
    trainer.init_state()
    if on_card:
        ra.roi_align_backward_cuda = record_k2
    try:
        steps(trainer, "[23] (a) note + masks warm-up", 1)
    finally:
        ra.roi_align_backward_cuda = real_k2
    steps(trainer, "[23] (a) note + masks warm-up", TRAIN_WARMUP - 1)
    sync()
    reset_peak()
    reset_launch_counts()
    times = steps(trainer, "[23] (a) note + masks", PAIR_TRAIN_STEPS)
    launches = read_launch_counts()
    per_step = {k: v / PAIR_TRAIN_STEPS for k, v in launches.items()}
    log(f"[23] (a) {PAIR_TRAIN_STEPS} note + masks steps of 2 + 2 images: median "
        f"{np.median(times):.2f} ms, peak device memory {peak_mib():.1f} MiB; loss_mask "
        f"{trainer.metrics_history[-1]['loss_mask']:.4g}; launches a step {per_step} (want K1 "
        f"2, K2 2, K3 1 for 4 images, no K4)")
    expect("note_masks", per_step, {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1,
                                    "nms_mask_images": 4, "bn_act_fwd": 0, "bn_act_bwd": 0})
    by_path["note_masks"] = launches
    if on_card:
        profile_run(trainer.run_step, "[23]", "note + masks train step", top=10)
        worst = 0.0
        for i, (g, rois, shape, a) in enumerate(k2_in):
            label = f"note + masks step g {list(g.shape)} onto {list(shape)}"
            k2_check(g.float(), rois, shape, p, label + " f32", tag="[23]")
            worst = max(worst, k2_check(g, rois, shape, p, label + " bf16", tag="[23]"))
            if i == 0:
                k_ms, p_ms, q_ms = k2_timed(g, rois, shape, label, tag="[23]", p=p)
                out_bytes = int(np.prod(shape)) * g.element_size()
                least = bound(nbytes(g, rois) + out_bytes, g.numel() * ROI_ALIGN_FLOPS)
                k2_out.update({"note_masks_train_ms": k_ms, "note_masks_train_queued_ms": q_ms,
                               "note_masks_train_plain_ms": p_ms,
                               "note_masks_train_bound_ms": least["bound_ms"],
                               "note_masks_train_shape": list(g.shape)})
        k2_out["note_masks_train_max_abs_err"] = worst
    del trainer, solver, model, strong, weak, k2_in[:]
    free()

    # engine.runner.run of the note + masks on phase 12's shapes-COCO
    # devkit: its loaders' polygon masks, 2 steps, the bbox and segm
    # evaluation of its 16 x 16 masks
    made = []

    class Recording(TrainerNoMeta):
        """The runner's trainer, kept so that the script can read its losses."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    DatasetCatalog.clear()
    args = runner.default_argument_parser().parse_args([
        "--config-file", str(NOTE_RECIPE), "--data-root", root, "--device", RUN_DEVICE,
        "OUTPUT_DIR", os.path.join(workdir, "note_masks_run"),
        "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
        "DATASETS.CLASSIFIER_DATAROOT", root, "SEED", str(seed), *PAIR_MASK_KEYS,
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "0",
        "TEST.EVAL_PERIOD", "0", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
        "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm", *RUN_EXTRA_OPTS])
    real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
    try:
        t0 = time.perf_counter()
        results = runner.run(args)
        sync()
        secs = time.perf_counter() - t0
    finally:
        runner.TrainerNoMeta = real_trainer
        DatasetCatalog.clear()
    history = made[-1].metrics_history
    aps = {task: {k: float(results[task][k]) for k in ("AP", "AP50")} for task in ("bbox", "segm")}
    log(f"[23] (a) run of the note + masks on the shapes-COCO devkit: {len(history)} steps "
        f"and the evaluation in {secs:.1f} s; loss_mask "
        f"{[round(m['loss_mask'], 4) for m in history]}; {aps}")
    if not (len(history) == 2 and all(np.isfinite(v) for m in history for v in m.values())
            and all(np.isfinite(v) for a in aps.values() for v in a.values())):
        raise AssertionError("the note + masks run left out a step or a finite loss or AP")
    del made[:]
    free()

    # (b), (c): the meta stream over InceptionResNetV2 and over VGG-CNN-F
    writer = runpy.run_path(str(ROOT / "scripts" / "make_shapes_proposals_torch.py"))
    for tag, path, name in (("(b)", NOTE_RECIPE, "note"), ("(c)", DOCK_RECIPE, "dock")):
        cfg = recipe(path, *PAIR_META_KEYS)
        model = flagship_model(cfg, seed, dev)
        mc = model.mc
        solver = build_optimizer(cfg, model)
        canvases = NOTE_CANVASES if name == "note" else PAIR_DOCK_CANVASES
        strong, weak = synthetic_train_batches(cfg, seed + 233, n_batches=2, canvases=canvases)
        if mc.load_proposals:
            topk = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN
            strong, weak = with_dock_proposals(writer["mcg_like_proposals"],
                                               np.random.RandomState(seed + 234), strong, weak,
                                               topk)
        support = synthetic_support_batches(cfg, seed + 235, n_batches=2)
        # the meta Res5, which no predict runs, calibrated on the shots
        shots0 = {k: torch.as_tensor(v, device=dev) for k, v in support[0].items()}
        frozen_bn_from_inputs(model.visual_attention.meta_box_head,
                              lambda: model.compute_meta_attention(shots0))
        del shots0
        shots = support[0]["image"].shape
        n_meta = sum(isinstance(m, FrozenBN)
                     for m in model.visual_attention.meta_box_head.modules())
        if on_card:  # the runner's Prefetcher pins every stream
            strong, weak, support = ([pin_batch(b) for b in s] for s in (strong, weak, support))
        trainer = Trainer(model, solver, itertools.cycle(strong), itertools.cycle(weak),
                          meta_iter=itertools.cycle(support), seed=seed)
        trainer.init_state()
        log(f"[23] {tag} {name} + meta: {type(model.backbone).__name__} "
            f"({model.backbone.out_channels} channels) + {type(model.box_head).__name__}, "
            f"{mc.pooler_type} at P = {mc.pooler_resolution}; the meta Res5 (depth {mc.depth}, "
            f"{n_meta} FrozenBN) over {model.backbone.out_channels} channels; support "
            f"{list(shots)} ({shots[0] * shots[1]} shots a step, pooled by ROIAlignV2 at P = "
            f"{model.visual_attention.pooler_resolution})")
        if on_card:
            ra.roi_align_cuda = record_k1
        try:
            steps(trainer, f"[23] {tag} {name} + meta warm-up", 1)
        finally:
            ra.roi_align_cuda = real_k1
        steps(trainer, f"[23] {tag} {name} + meta warm-up", TRAIN_WARMUP - 1)
        sync()
        reset_peak()
        reset_launch_counts()
        times = steps(trainer, f"[23] {tag} {name} + meta", PAIR_TRAIN_STEPS)
        launches = read_launch_counts()
        per_step = {k: v / PAIR_TRAIN_STEPS for k, v in launches.items()}
        last = trainer.metrics_history[-1]
        log(f"[23] {tag} {PAIR_TRAIN_STEPS} {name} + meta Trainer steps of 2 + 2 images and "
            f"{shots[0] * shots[1]} shots: median {np.median(times):.2f} ms, peak device "
            f"memory {peak_mib():.1f} MiB; rank losses margin {last['loss_rank_margin']:.6g} "
            f"(the underflow's {(len(mc.base_ids)) * 0.5 / (len(mc.base_ids) + 1):.6g}), reg "
            f"{last['loss_rank_reg']:.4g}, cls {last['loss_rank_cls']:.4g}; launches a step "
            f"{per_step}")
        # the note: K1 over the strong and weak ROIs and the shots, K2 for the
        # first two (the shots and the query maps are detached), one K3 for
        # the 4 images' RPN; the dock: ROIPool and proposals, so K1 over the
        # shots alone; both: K4 in the meta head over the shots and over the
        # query slots, forward and backward
        heads = {"bn_act_fwd": 2 * n_meta, "bn_act_bwd": 2 * n_meta}
        expect(f"{name}_meta", per_step, (
            {"roi_align_fwd": 3, "roi_align_bwd": 2, "nms_mask": 1, "nms_mask_images": 4}
            if name == "note" else
            {"roi_align_fwd": 1, "roi_align_bwd": 0, "nms_mask": 0, "nms_mask_images": 0})
            | heads)
        by_path[f"{name}_meta"] = launches
        if on_card:
            profile_run(trainer.run_step, "[23]", f"{name} + meta train step", top=10)
            shot_in = [(f, r, a) for f, r, a in k1_in
                       if r.shape[1] == 1 and f.shape[0] == shots[0] * shots[1]]
            if len(shot_in) != 1:
                raise AssertionError(f"{name} + meta: {len(shot_in)} K1 launches over the shots "
                                     "in the warm-up step")
            (f, r, a), = shot_in
            # K1's f32 bound is for features of order 1: scaled by a power of two
            rms = float(f.float().square().mean().sqrt())
            f = f * 2.0 ** -round(np.log2(rms))
            pk = a[0] if a else p
            label = f"{name} support {list(f.shape)} x 1 ROI P={pk} (RMS {rms:.4g} scaled)"
            err = k1_check(f, r, label, tag="[23]", p=pk)
            k_ms, p_ms, least = k1_timed(f, r, label, tag="[23]", p=pk)
            k1_out.update({f"{name}_support_ms": k_ms, f"{name}_support_plain_ms": p_ms,
                           f"{name}_support_bound_ms": least["bound_ms"],
                           f"{name}_support_max_abs_err": err,
                           f"{name}_support_shape": list(f.shape) + [1, pk]})
            # K4 at the meta head's shapes over the query slots: res5's first
            # block after its stride-2 1x1 (P -> ceil(P / 2))
            n_q = 2 * min(mc.rank_loss_slots, mc.roi_batch_size)
            side = -(-mc.pooler_resolution // 2)
            width = 8 * mc.res2_out_channels
            k4_rng = np.random.RandomState(seed + 236)
            rows = [k4_case(k4_rng, (n_q, side, side, width // 4), False, True, tag="[23]"),
                    k4_case(k4_rng, (n_q, side, side, width), True, True, tag="[23]")]
            k4_out.update({f"{name}_meta_head_ms": rows[1]["ms"],
                           f"{name}_meta_head_plain_ms": rows[1]["plain_ms"],
                           f"{name}_meta_head_bound_ms": rows[1]["bound_ms"],
                           f"{name}_meta_head_max_abs_err": max(r["max_abs_err"] for r in rows),
                           f"{name}_meta_head_shape": [n_q, side, side, width]})
        del trainer, solver, strong, weak, support, k1_in[:]
        free()

        # the prototypes of the suite's registered support set, as an
        # evaluation binds them (R21: the evaluation itself looks the set up
        # under the VOC name, as unit_tpu's does)
        cfg_e = cfg.clone()
        cfg_e.DATASETS.BASE_META_SHOTS = PAIR_SUPPORT_SHOTS
        DatasetCatalog.clear()
        register_datasets(cfg_e, root)
        support_name = f"coco_{name}_base_training_support"
        t0 = time.perf_counter()
        att = runner.meta_attention(cfg_e, model.eval(), dataset_name=support_name)
        sync()
        secs = time.perf_counter() - t0
        finite = int(torch.isfinite(att.logdet).sum())
        log(f"[23] {tag} meta_attention over {support_name} ({PAIR_SUPPORT_SHOTS} shots a "
            f"class) in {secs:.2f} s: prototypes {list(att.mean.shape)}, {finite} finite "
            f"slots, finite means {bool(torch.isfinite(att.mean).all())}; the evaluation's own "
            f"lookup, {runner.support_dataset_name(cfg_e)}, registered "
            f"{runner.support_dataset_name(cfg_e) in DatasetCatalog}")
        if not (att.mean.shape == (mc.num_classes + 1, 8 * mc.res2_out_channels)
                and finite == len(mc.base_ids) + 1 and bool(torch.isfinite(att.mean).all())):
            raise AssertionError(f"{name} + meta: the registered support set's prototypes")
        DatasetCatalog.clear()
        del model, att
        free()
    if wrong:
        raise AssertionError("phase 23 launches: " + "; ".join(wrong))
    log(f"[23] phase 23 in {time.perf_counter() - t_phase:.1f} s")
    return by_path, k1_out, k2_out, k4_out


DP_WORLD = 2
DP_IMAGES_PER_RANK = 4      # the recipe's IMS_PER_BATCH 8: 4 + 4 images a rank
DP_WARMUP, DP_STEPS = 1, 3
DP_RUN_STEPS, DP_RUN_PERIOD = 4, 2
DP_DIST_STEPS = 2
DP_STOP_DEPTH, DP_STOP_AT, DP_STOP_MAX = 8, 1, 12  # (e): stop asked on rank 1 after step 1
DP_STOP_IMAGES = 2          # (e): 2 + 2 images a rank
DP_TIMEOUT = 600            # seconds a launch may take, collectives and join
DP_AP_ATOL = 1e-6
# the merged evaluator's detections against one process's (class, image,
# score and box): random weights find no object at AP50, so the detections
# carry the comparison
DP_DET_ATOL = 1e-3
# (b): every candidate kept, so that the ranks' samplers select what one
# process selects: the RPN's 63000 anchors of an 800x1344 canvas under its
# per-image batch, all 128 proposals and the 100 GT slots under the ROI batch
# of 512 (the recipe's), and no cap on the foreground
DP_KEEP_ALL_OPTS = ("TPU.COMPUTE_DTYPE", "float32", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "128",
                    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "100000",
                    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "512",
                    "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
                    "SOLVER.CLIP_GRADIENTS.ENABLED", "False")


def dp_cfg(opts):
    """The flagship with the smoke's clipping (random weights) and ``opts``."""
    from unit_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(FLAGSHIP))
    cfg.merge_from_list(["SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                         "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm", *opts])
    return cfg


def state_digest(model):
    """A hash of every parameter and buffer of ``model``, bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def buffers_digest(model):
    """A hash of ``model``'s buffers (whole on every rank under FSDP and TP)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in model.named_buffers():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def timed_grad_reduce(sync, into):
    """Wrap the train step's gradient all-reduce (parallel.comm): its host ms,
    the device synchronised on both sides, go to ``into``; returns the
    function that restores it (the rank process goes on to phase 22)."""
    from unit_tpu_torch.parallel import comm

    real = comm.all_reduce_mean_tensors

    def timed(*a, **kw):
        sync()
        t = time.perf_counter()
        real(*a, **kw)
        sync()
        into.append((time.perf_counter() - t) * 1e3)

    comm.all_reduce_mean_tensors = timed
    return lambda: setattr(comm, "all_reduce_mean_tensors", real)


def dp_train_rank(device, opts, seed, per_rank, canvases, warmup, steps):
    """(a), one rank: the flagship at full width on this rank's own images,
    ``warmup`` + ``steps`` steps; the timed steps' times, gradient
    all-reduce ms, launches, peak memory, losses and the state's digest."""
    import torch

    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.parallel import comm
    from unit_tpu_torch.solver import build_optimizer

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = dp_cfg(opts)
    t0 = time.perf_counter()
    model = flagship_model(cfg, seed, device)
    strong, weak = synthetic_train_batches(cfg, seed + 1000 * (comm.rank() + 1),
                                           per_stream=per_rank, canvases=canvases)
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.cycle(strong),
                            itertools.cycle(weak), seed=seed)
    trainer.init_state()
    reduce_ms = []
    restore = timed_grad_reduce(sync, reduce_ms)
    for _ in range(warmup):
        trainer.run_step()
    setup_s = time.perf_counter() - t0
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reduce_ms.clear()
    step_ms = []
    for _ in range(steps):
        t = time.perf_counter()
        trainer.run_step().resolve()  # read now: the clock holds the device's time
        step_ms.append((time.perf_counter() - t) * 1e3)
    restore()
    launches = read_launch_counts()
    n_backbone, n_res5, n_trainable = frozen_bn_counts(model)
    return {"rank": comm.rank(), "step_ms": step_ms, "reduce_ms": reduce_ms,
            "setup_s": setup_s, "launches": launches,
            "k4": (n_backbone + 3 * n_res5, n_trainable + 2 * n_res5),
            "peak": torch.cuda.max_memory_allocated(device) if on_card else 0,
            "grad_mib": sum(p.numel() * p.element_size()
                            for g in trainer.optimizer.optimizer.param_groups
                            for p in g["params"]) / 2**20,
            "losses": [m["total_loss"] for m in trainer.metrics_history],
            "finite": all(np.isfinite(v) for m in trainer.metrics_history for v in m.values()),
            "digest": state_digest(model)}


def dp_f32_step(device, opts, seed, strong, weak, out_path=None):
    """(b): one f32 step (TF32 off) of the flagship on this process's rows of
    ``strong``/``weak`` (all of them in one process): (losses, the gradient
    that enters the optimizer, after the ranks' all-reduce).  A rank saves
    the gradient to ``out_path`` instead (rank 0) and returns None for it."""
    import torch

    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.parallel import comm
    from unit_tpu_torch.solver import build_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = dp_cfg((*opts, *DP_KEEP_ALL_OPTS))
    model = flagship_model(cfg, seed, device)
    solver = build_optimizer(cfg, model)
    r, n = comm.rank(), comm.world()
    rows = len(strong["image"]) // n

    def mine(batch):
        return {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}

    trainer = TrainerNoMeta(model, solver, itertools.repeat(mine(strong)),
                            itertools.repeat(mine(weak)), seed=seed)
    trainer.init_state()
    names = {id(p): name for name, p in model.named_parameters()}
    grads = {}
    real = comm.all_reduce_mean_tensors

    def keep(tensors):
        real(tensors)
        params = [p for g in solver.optimizer.param_groups for p in g["params"]]
        grads.update({names[id(p)]: t.detach().clone() for p, t in zip(params, tensors)})

    comm.all_reduce_mean_tensors = keep
    try:
        metrics = dict(trainer.run_step())  # resolved on every rank here
    finally:
        comm.all_reduce_mean_tensors = real
    del trainer, model
    if out_path is None:
        return metrics, grads
    if comm.is_main():
        torch.save({k: v.cpu() for k, v in grads.items()}, out_path)
    return metrics, None


def recording_merges(merged):
    """Make the inference loop's ``merge_gathered`` append each merged VOC
    evaluator's detections (``voc_detections``) to ``merged``; returns the
    function to restore."""
    from unit_tpu_torch.evaluation import evaluator as ev_mod

    real = ev_mod.merge_gathered

    def merge(evaluator):
        out = real(evaluator)
        merged.append(voc_detections(out))
        return out

    ev_mod.merge_gathered = merge
    return real


def voc_detections(evaluator):
    """A VOC evaluator's detections as a sorted [N, 6] array (class, image
    index, score, box) with the image ids beside it."""
    rows, images = [], sorted({d[0] for dets in evaluator._dets.values() for d in dets})
    index = {img: i for i, img in enumerate(images)}
    for cid, dets in evaluator._dets.items():
        rows += [(cid, index[d[0]], *d[1:]) for d in dets]
    return np.asarray(sorted(rows), np.float64).reshape(-1, 7), images


def dp_run_rank(device, argv, sharded=False):
    """(c), one rank of engine.runner.run in the caller's group: the results,
    the detections of each merged evaluation, each step's launches and
    losses, and the final state's digest.  ``sharded`` (phase 22, a run
    under TPU.FSDP or TPU.TP): also each step's host ms, the digests of the
    gathered state and of the parameters
    no mode split, each split parameter's (local, whole) elements, the
    whole model's bytes, whether the buffers (the FrozenBN statistics)
    changed from the first step to the end, the PreciseBN refreshes and,
    on the card, each step's device memory (allocated at its start and
    end, its peak, and the peak of the hooks before it: the
    evaluations)."""
    import torch

    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import TrainerNoMeta
    from unit_tpu_torch.evaluation import evaluator as ev_mod
    from unit_tpu_torch.parallel import comm
    from unit_tpu_torch.parallel import mesh as mesh_lib

    made, merged = [], []
    on_card = device.type == "cuda"

    class Recording(TrainerNoMeta):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.launches, self.memory, self.step_ms = [], [], []
            if sharded:  # each step read at its end: its clock holds the device's time
                self.metrics_pipeline_depth = 0
            made.append(self)

        def run_step(self):
            if sharded and not self.launches:
                self.buffers = buffers_digest(self.model)
            if on_card and sharded:
                start = torch.cuda.memory_allocated(device)
                hooks_peak = torch.cuda.max_memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
            reset_launch_counts()
            t = time.perf_counter()  # the step ends in its one fetch of the ranks' losses
            metrics = super().run_step()
            self.step_ms.append((time.perf_counter() - t) * 1e3)
            self.launches.append(read_launch_counts())
            if on_card and sharded:
                self.memory.append({"start": start, "hooks_peak": hooks_peak,
                                    "peak": torch.cuda.max_memory_allocated(device),
                                    "end": torch.cuda.memory_allocated(device)})
                torch.cuda.reset_peak_memory_stats(device)
            return metrics

    real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
    real_merge = recording_merges(merged)
    refreshes = count_calls(runner, "precise_bn")
    DatasetCatalog.clear()
    try:
        results = runner.run(runner.default_argument_parser().parse_args(argv))
    finally:
        runner.TrainerNoMeta, ev_mod.merge_gathered = real_trainer, real_merge
        runner.precise_bn = refreshes["real"]
    trainer = made[-1]
    first = trainer.state.step - len(trainer.metrics_history)
    n_backbone, n_res5, n_trainable = frozen_bn_counts(trainer.model)
    out = {"results": results, "launches": trainer.launches, "merged": merged,
           "k4": (n_backbone + 3 * n_res5, n_trainable + 2 * n_res5),
           "frozen_bn": (n_backbone, n_res5, n_trainable),
           "stage": getattr(trainer, "_stage", None),
           "losses": {first + 1 + k: {n: v for n, v in m.items() if n != "data_time"}
                      for k, m in enumerate(trainer.metrics_history)}}
    if not sharded:
        out["digest"] = state_digest(trainer.model)
        return out
    model = trainer.model
    split = {name: (p.to_local().numel() if hasattr(p, "to_local") else p.numel(),
                    int(np.prod(mesh_lib.full_shape(p))))
             for name, p in model.named_parameters() if comm.is_split(p)}
    out.update(rank=comm.rank(), digests=sh_digests(model), memory=trainer.memory,
               step_ms=trainer.step_ms, split=split,
               buffers_changed=buffers_digest(model) != trainer.buffers,
               refreshes=refreshes["n"],
               finite=all(np.isfinite(v) for m in trainer.metrics_history for v in m.values()),
               whole_bytes=sum(int(np.prod(mesh_lib.full_shape(t))) * t.element_size()
                               for t in itertools.chain(model.parameters(), model.buffers())))
    return out


def check_eval_alone(tag, step, argv, ap, gathered):
    """A one-process ``--eval-only`` (``argv``) of the ``step`` checkpoint
    against a run's gathered evaluation: its AP ``ap`` within DP_AP_ATOL, and
    the merged evaluator's detections ``gathered`` (``voc_detections``)
    within DP_DET_ATOL of the one process's."""
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.evaluation import evaluator as ev_mod

    DatasetCatalog.clear()
    merged = []
    real_merge = recording_merges(merged)
    try:
        alone = runner.run(runner.default_argument_parser().parse_args(argv))
    finally:
        ev_mod.merge_gathered = real_merge
    off = max(abs(alone["bbox"][k] - ap[k]) for k in ("AP", "AP50", "AP75"))
    (dets, images), (ref, ref_images) = gathered, merged[-1]
    same_dets = dets.shape == ref.shape and images == ref_images
    det_off = float(np.abs(dets - ref).max()) if same_dets and dets.size else 0.0
    log(f"{tag} one-process --eval-only of the {step} checkpoint: AP50 "
        f"{alone['bbox']['AP50']:.6g}, max |diff| from the gathered AP {off:.3g} "
        f"(tol {DP_AP_ATOL}); the gathered evaluator's {len(dets)} detections of "
        f"{len(images)} images against the one process's {len(ref)}: bit-identical "
        f"{same_dets and np.array_equal(dets, ref)}, max |diff| (score, box px) {det_off:.3g} "
        f"(tol {DP_DET_ATOL})")
    if not (off <= DP_AP_ATOL and same_dets and len(dets) > 0 and det_off <= DP_DET_ATOL):
        raise AssertionError("the gathered evaluation is not the one-process evaluation")


class StopOnRankOne:
    """A trainer hook that takes a step's losses in flight and asks rank 1
    alone to stop after step ``at``."""

    takes_lazy_metrics = True

    def __init__(self, at):
        self.at = at

    def __call__(self, step, metrics, trainer):
        from unit_tpu_torch.parallel import comm

        if comm.rank() == 1 and step == self.at:
            trainer.request_stop()


def dp_stop_rank(device, opts, seed, per_rank, canvases):
    """(e), one rank: the flagship at full width on this rank's own images,
    trained to DP_STOP_MAX steps at metrics_pipeline_depth DP_STOP_DEPTH
    with a stop requested on rank 1 alone after step DP_STOP_AT: (the step
    it stopped at, whether it saw the request, each step's total_loss, the
    seconds)."""
    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.parallel import comm
    from unit_tpu_torch.solver import build_optimizer

    t = time.perf_counter()
    cfg = dp_cfg(opts)
    model = flagship_model(cfg, seed, device)
    strong, weak = synthetic_train_batches(cfg, seed + 4000 * (comm.rank() + 1),
                                           n_batches=2, per_stream=per_rank, canvases=canvases)
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.cycle(strong),
                            itertools.cycle(weak), seed=seed)
    trainer.metrics_pipeline_depth = DP_STOP_DEPTH
    trainer.init_state()
    trainer.train(DP_STOP_MAX, hooks=[StopOnRankOne(DP_STOP_AT)])
    out = (trainer.state.step, trainer.stop_requested,
           [m["total_loss"] for m in trainer.metrics_history], time.perf_counter() - t)
    trainer.close()
    return out


def dp_all_rank(device, train_args, f32_args, run_args, stop_args):
    """(a), (b), (c) and (e) in one rank process (one spawn): ``dp_train_rank(
    *train_args)``, ``dp_f32_step(*f32_args)``, then the run and its resume
    (``dp_run_and_resume_rank(*run_args)``) with their seconds, then
    ``dp_stop_rank(*stop_args)``."""
    import torch

    a, b = dp_train_rank(device, *train_args), dp_f32_step(device, *f32_args)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    c = dp_run_and_resume_rank(device, *run_args)
    c = (c, time.perf_counter() - t)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return a, b, c, dp_stop_rank(device, *stop_args)


def dp_run_and_resume_rank(device, argv_a, argv_b, out_a, out_b):
    """(c) in one rank process: the run into ``out_a``, then (rank 0 copies
    its step-2 checkpoint into ``out_b``) the run resumed from it."""
    from unit_tpu_torch.parallel import comm

    a = dp_run_rank(device, argv_a)
    if comm.is_main():
        os.makedirs(out_b)
        shutil.copy(os.path.join(out_a, f"step_{DP_RUN_PERIOD}.pt"), out_b)
    comm.barrier()
    return a, dp_run_rank(device, argv_b)


def dp_run_argv(seed, workdir, dev, opts):
    """(argv(out, *flags), init): the flagship's run-loop command line on
    phase 20's devkit of JPEG files, from ``init``, a checkpoint of the
    seeded flagship (``flagship_model``; both made in ``workdir`` once,
    shared by phases 21 and 22): 2 + 2 images a rank at world 2,
    DP_RUN_STEPS steps, a checkpoint and an evaluation every DP_RUN_PERIOD
    (later options override them)."""
    import torch

    from unit_tpu_torch.checkpoint import Checkpointer
    from unit_tpu_torch.engine.train import TrainState
    from unit_tpu_torch.solver import build_optimizer

    devkit = os.path.join(workdir, "VOCdevkit_jpeg")
    if not os.path.isdir(devkit):
        write_devkit(devkit, seed, shapes=HOST_WIRE_RUN_SHAPES, jpegs=True)
    cfg = dp_cfg(opts)
    init = os.path.join(workdir, "dp_init", "step_0.pt")
    if not os.path.isfile(init):
        model = flagship_model(cfg, seed, dev)
        init = Checkpointer(os.path.dirname(init)).save(
            0, TrainState(model, build_optimizer(cfg, model), 0), wait=True)
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def argv(out, *flags):
        return ["--config-file", str(FLAGSHIP), "--data-root", devkit, "--device", RUN_DEVICE,
                *flags, "MODEL.WEIGHTS", init, "OUTPUT_DIR", out,
                "MODEL.ROI_HEADS.EMBEDDING_PATH", str(ROOT / cfg.MODEL.ROI_HEADS.EMBEDDING_PATH),
                "DATASETS.CLASSIFIER_DATAROOT", devkit, "SEED", str(seed),
                "SOLVER.IMS_PER_BATCH", str(2 * DP_WORLD), "SOLVER.MAX_ITER", str(DP_RUN_STEPS),
                "SOLVER.CHECKPOINT_PERIOD", str(DP_RUN_PERIOD),
                "TEST.EVAL_PERIOD", str(DP_RUN_PERIOD),
                "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                *opts]
    return argv, init


def phase_data_parallel(seed, workdir):
    """Phase 21: data parallelism on one card.  (a) the flagship at full
    width at the recipe's global batch, 4 + 4 images a rank on 2 ranks (gloo,
    both on card 0): per rank the step median, the gradient all-reduce's ms a
    step and the peak memory, every step's launches (K1 2, K2 2, K3 1, K4
    124 + 103), finite losses and one state on both ranks; (b) f32, TF32
    off, every candidate kept: one step at world 2 of 1 + 1 images a rank
    against one process on the 2 + 2 global batch, the losses to 1e-4 and
    the gradients to phase 8's bound; (c) engine.runner.run at world 2 on a
    devkit of JPEG files through the C loader: 4 steps, a checkpoint and an
    evaluation at 2 and 4, only rank 0 writing, the gathered AP against a
    one-process --eval-only of the step-4 checkpoint, a resume from step 2;
    (d) --dist at world 1 over NCCL (torchrun's environment): 2 steps, their
    launches, finite losses, one NCCL all-reduce; (e) in the spawn, a stop
    asked on rank 1 alone at metrics_pipeline_depth 8 (``dp_stop_rank``):
    both ranks on one step, within the depth, with the same losses.  A
    generator
    (``phase_multi_rank``): it yields ``dp_all_rank``'s arguments, gets
    back each rank's (result, seconds) from the spawn phases 21 and 22
    share, and returns {path: launch counts}."""
    import socket

    import torch
    import torch.distributed as dist

    from unit_tpu_torch.checkpoint import read_checkpoint
    from unit_tpu_torch.data import DatasetCatalog
    from unit_tpu_torch.engine import runner
    from unit_tpu_torch.engine.train import TrainerNoMeta

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    opts = list(RUN_EXTRA_OPTS)
    by_path = {}
    if on_card:
        torch.cuda.empty_cache()

    # (b)'s one process first: its gradient waits on the card for the ranks'
    cfg32 = dp_cfg((*opts, *DP_KEEP_ALL_OPTS))
    strong, weak = synthetic_train_batches(cfg32, seed + 5, n_batches=1, per_stream=DP_WORLD)
    strong, weak = strong[0], weak[0]
    t = time.perf_counter()
    m1, g1 = dp_f32_step(dev, opts, seed, strong, weak)
    secs_one = time.perf_counter() - t
    if on_card:
        torch.cuda.empty_cache()

    argv, _ = dp_run_argv(seed, workdir, dev, opts)

    # (a) world 2 at the recipe's global batch, (b) world 2, then (c) the run
    # loop at world 2 and its resume, in the shared spawn
    grads_path = os.path.join(workdir, "dp_f32_grads.pt")
    out_a, out_b = os.path.join(workdir, "dp_run_a"), os.path.join(workdir, "dp_run_b")
    spawned = yield ((opts, seed, DP_IMAGES_PER_RANK, TRAIN_CANVASES, DP_WARMUP, DP_STEPS),
                     (opts, seed, strong, weak, grads_path),
                     (argv(out_a), argv(out_b, "--resume"), out_a, out_b),
                     (opts, seed, DP_STOP_IMAGES, TRAIN_CANVASES))
    both = [r for r, _ in spawned]
    secs = max(t for _, t in spawned)
    ranks = [r[0] for r in both]
    for r in ranks:
        log(f"[21] (a) rank {r['rank']}: {DP_STEPS} timed steps of {DP_IMAGES_PER_RANK} + "
            f"{DP_IMAGES_PER_RANK} images, median {np.median(r['step_ms']):.2f} ms (min "
            f"{min(r['step_ms']):.2f}, max {max(r['step_ms']):.2f}), gradient all-reduce "
            f"({r['grad_mib']:.1f} MiB, gloo through the host) median "
            f"{np.median(r['reduce_ms']):.2f} ms a step, peak device memory "
            f"{r['peak'] / 2**30:.2f} GiB, set-up + {DP_WARMUP} warm-up steps "
            f"{r['setup_s']:.1f} s; launches {r['launches']}; total_loss "
            f"{[round(v, 4) for v in r['losses']]}")
    k4_fwd, k4_bwd = ranks[0]["k4"]
    want = {"roi_align_fwd": 2 * DP_STEPS, "roi_align_bwd": 2 * DP_STEPS,
            "nms_mask": DP_STEPS, "nms_mask_images": 2 * DP_IMAGES_PER_RANK * DP_STEPS,
            "bn_act_fwd": k4_fwd * DP_STEPS, "bn_act_bwd": k4_bwd * DP_STEPS,
            "bn_act_layout_copies": 2 * DP_STEPS}
    same = len({r["digest"] for r in ranks}) == 1
    slowest = max(np.median(r["step_ms"]) for r in ranks)
    log(f"[21] (a) + (b) + (c) {DP_WORLD} ranks in {secs:.1f} s of the spawn (builds, steps); "
        f"(a)'s state's hash equal on every rank {same}; global images/s "
        f"{1e3 * 2 * DP_IMAGES_PER_RANK * DP_WORLD / slowest:.2f}")
    if not (same and all(r["finite"] for r in ranks)) or len(
            {tuple(r["losses"]) for r in ranks}) != 1:
        raise AssertionError("the ranks' states or losses differ, or a loss is not finite")
    if on_card and any(r["launches"] != want for r in ranks):
        raise AssertionError(f"a rank did not launch {want} in its timed steps: "
                             f"{[r['launches'] for r in ranks]}")
    for r in ranks:
        by_path[f"dp_train_rank{r['rank']}"] = r["launches"]

    # (b) f32: world 2 (1 + 1 a rank) against one process on the 2 + 2 batch
    m2, _ = both[0][1]
    g2 = torch.load(grads_path, map_location=dev, weights_only=True)
    os.remove(grads_path)
    loss_rel = max(abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-12) for k in m1 if k != "data_time")
    big = max(float(g.abs().max()) for g in g1.values())
    over = {n: float((g2[n] - g1[n]).abs().max()) / (TRAIN_GRAD_REL * float(g1[n].abs().max())
                                                      + TRAIN_GRAD_FLOOR * big)
            for n in g1}
    worst = sorted(over, key=over.get, reverse=True)[:3]
    log(f"[21] (b) f32, TF32 off, every candidate kept (the one process {secs_one:.1f} s): "
        f"world 2 (1 + 1 a rank) against one process (2 + 2): losses max rel diff "
        f"{loss_rel:.3g} (tol {TRAIN_LOSS_RTOL}); {len(g1)} gradients, worst max|diff|/bound "
        f"{over[worst[0]]:.3g} (bound {TRAIN_GRAD_REL} * max|g_leaf| + {TRAIN_GRAD_FLOOR} * "
        f"G, G = {big:.4g}): " + ", ".join(f"{n} {over[n]:.3g}" for n in worst))
    if set(g2) != set(g1) or loss_rel > TRAIN_LOSS_RTOL or over[worst[0]] > 1.0:
        raise AssertionError("the world-2 f32 step is not the one-process step")
    del g1, g2
    if on_card:
        torch.cuda.empty_cache()

    # (c) the run loop at world 2 on JPEG files (phase 20's devkit)
    ((a, a2), secs_a), ((b, _), _) = both[0][2], both[1][2]
    k4_fwd, k4_bwd = a["k4"]
    want = {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1, "nms_mask_images": 4,
            "bn_act_fwd": k4_fwd, "bn_act_bwd": k4_bwd, "bn_act_layout_copies": 2}
    written = sorted(os.listdir(out_a))
    ap = a["results"]["bbox"]
    log(f"[21] (c) run at world 2 ({DP_RUN_STEPS} steps of 2 + 2 images a rank through the C "
        f"loader, checkpoints and evaluations at {DP_RUN_PERIOD} and {DP_RUN_STEPS}) and its "
        f"resume in the spawn of (a) and (b), {secs_a:.1f} s of it: AP50 {ap['AP50']:.6g}, "
        f"AP {ap['AP']:.6g}, the "
        f"ranks' results equal {strip_results(a['results']) == strip_results(b['results'])}, "
        f"states equal {a['digest'] == b['digest']}; OUTPUT_DIR holds {written}; rank 0's "
        f"launches a step {a['launches'][-1]}")
    if on_card and any(c != want for r in (a, b) for c in r["launches"]):
        raise AssertionError(f"a run-loop step did not launch {want}: "
                             f"{[r['launches'] for r in (a, b)]}")
    if a["digest"] != b["digest"] or strip_results(a["results"]) != strip_results(
            b["results"]) or not {"step_2.pt", "step_4.pt", "metrics.json"} <= set(written):
        raise AssertionError("the ranks' runs differ, or a checkpoint is missing")
    by_path["dp_run_loop"] = {k: sum(c[k] for c in a["launches"]) for k in want}

    check_eval_alone("[21] (c)", f"step-{DP_RUN_STEPS}", argv(out_a, "--eval-only", "--resume"),
                     ap, a["merged"][-1])

    rel = max(abs(a2["losses"][s][k] - a["losses"][s][k]) / max(abs(a["losses"][s][k]), 1e-12)
              for s in a2["losses"] for k in a2["losses"][s])
    ma = read_checkpoint(os.path.join(out_a, f"step_{DP_RUN_STEPS}.pt"))
    mb = read_checkpoint(os.path.join(out_b, f"step_{DP_RUN_STEPS}.pt"))
    same_params = all(torch.equal(ma["model"][k], mb["model"][k]) for k in ma["model"])
    log(f"[21] (c) resumed at world 2 from step {DP_RUN_PERIOD}: steps "
        f"{sorted(a2['losses'])}, losses max rel diff "
        f"{rel:.3g} (tol {RESUME_LOSS_RTOL}), step-{DP_RUN_STEPS} checkpoint bit-identical "
        f"{same_params}")
    if sorted(a2["losses"]) != list(range(DP_RUN_PERIOD + 1, DP_RUN_STEPS + 1)) \
            or not rel <= RESUME_LOSS_RTOL:
        raise AssertionError("the resumed world-2 run does not reproduce its steps")

    # (e) a stop on rank 1 alone with the losses read 8 steps late: the
    # request reaches rank 0 in the all-reduce of the first resolution
    stops = [r[3] for r in both]
    log(f"[21] (e) metrics_pipeline_depth {DP_STOP_DEPTH}, a stop asked on rank 1 alone after "
        f"step {DP_STOP_AT} of {DP_STOP_MAX}: the ranks stopped after steps "
        f"{[x[0] for x in stops]}, saw the request {[x[1] for x in stops]}, logged the same "
        f"losses {stops[0][2] == stops[1][2]} (total_loss {[round(v, 4) for v in stops[0][2]]}); "
        f"{max(x[3] for x in stops):.1f} s with the build")
    if not (stops[0][:2] == stops[1][:2] == (DP_STOP_AT + DP_STOP_DEPTH, True)
            and stops[0][2] == stops[1][2] and len(stops[0][2]) == stops[0][0]
            and all(np.isfinite(v) for v in stops[0][2])):
        raise AssertionError("the ranks did not stop together, within the depth of the "
                             "request, with the same losses")

    # (d) --dist: one rank over NCCL, from torchrun's environment
    made = []

    class Recording(TrainerNoMeta):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.launches, self.checks = [], []
            made.append(self)

        def run_step(self):
            reset_launch_counts()
            metrics = super().run_step()
            self.launches.append(read_launch_counts())
            one = torch.ones(1, device=dev)
            dist.all_reduce(one)  # one collective of the group, beside the step's
            self.checks.append((dist.get_backend(), dist.get_world_size(), float(one)))
            return metrics

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    real_trainer, runner.TrainerNoMeta = runner.TrainerNoMeta, Recording
    t = time.perf_counter()
    try:
        DatasetCatalog.clear()
        results = runner.run(runner.default_argument_parser().parse_args(
            argv(os.path.join(workdir, "dp_dist"), "--dist")
            + ["SOLVER.MAX_ITER", str(DP_DIST_STEPS), "SOLVER.IMS_PER_BATCH", "2",
               "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0"]))
    finally:
        runner.TrainerNoMeta = real_trainer
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    trainer = made[-1]
    finite = all(np.isfinite(v) for m in trainer.metrics_history for v in m.values())
    log(f"[21] (d) --dist, 1 rank, {DP_DIST_STEPS} steps in {time.perf_counter() - t:.1f} s: "
        f"group {trainer.checks}, launches a step {trainer.launches[-1]}, AP50 "
        f"{results['bbox']['AP50']:.4g}, losses finite {finite}, the group destroyed "
        f"{not dist.is_initialized()}")
    backend = "nccl" if on_card else "gloo"
    if not finite or dist.is_initialized() or len(trainer.launches) != DP_DIST_STEPS \
            or any(c != (backend, 1, 1.0) for c in trainer.checks):
        raise AssertionError(f"the --dist run did not train over {backend}")
    if on_card and any(c != want for c in trainer.launches):
        raise AssertionError(f"a --dist step did not launch {want}: {trainer.launches}")
    by_path["dp_dist"] = {k: sum(c[k] for c in trainer.launches) for k in want}
    del trainer
    made.clear()
    if on_card:
        torch.cuda.empty_cache()
    return by_path


# Phase 22: FSDP and tensor parallelism on one card.  As in phase 21, NCCL
# refuses two ranks on one device, so the two ranks share card 0 over gloo,
# which stages every collective's CUDA tensors through the host: FSDP2's
# all-gathers and reduce-scatters, each TP layer's all-gather and
# input-gradient all-reduce.  The step times are the cost of gloo on one
# card, not FSDP or TP figures.
SH_WORLD = 2
SH_TIMEOUT = 900                    # seconds a launch may take, collectives and join
SH_LOSS_RTOL = 1e-5                 # (c): the split f32 step's losses against one process's
# (a) and (b) drive engine.runner.run under each mode on phase 20's JPEG
# devkit from phase 21's initial checkpoint: a warm-up step, then the timed
# ones, the last under the profiler; an evaluation on a whole replica and a
# checkpoint every SH_RUN_PERIOD steps (under FSDP a step follows an
# evaluation: the memory it leaves; TP's evaluation goes through the same
# whole replica, ``runner.on_whole_replica``)
SH_RUN_PERIOD = 2
SH_MODES = {  # mode: (images a rank and stream, warm-up steps, timed steps, options)
    "fsdp": (4, 1, 3, ("TPU.FSDP", "True")),  # phase 21's 4 + 4 a rank
    # 1 + 1 on its one data rank, 5-9 s a step through gloo; PreciseBN before
    # each evaluation, on the replica, the statistics copied back
    "tp": (1, 1, 1, ("TPU.TP", str(SH_WORLD), "TEST.PRECISE_BN.ENABLED", "True",
                     "TEST.PRECISE_BN.NUM_ITER", "1")),
}
SH_FSDP_LEAF = "backbone.res4.block0.conv1.weight"


def sh_split(model, mode, device):
    """(model split over two ranks as ``mode`` says, its mesh)."""
    from unit_tpu_torch.parallel import comm
    from unit_tpu_torch.parallel import mesh as mesh_lib

    if mode == "fsdp":
        mesh = mesh_lib.make_mesh(comm.world(), device.type)
        mesh_lib.fsdp_shard(model, mesh)
    else:
        mesh = mesh_lib.make_mesh_tp(1, comm.world(), device.type)
        mesh_lib.tp_shard(model, mesh)
    return model, mesh


def sh_digests(model, optimizer=None):
    """Hashes of the gathered parameters and buffers (a collective), of the
    parameters no mode split, and with ``optimizer`` of the gathered momenta."""
    import hashlib

    import torch

    from unit_tpu_torch.parallel import comm
    from unit_tpu_torch.parallel import mesh as mesh_lib

    def h(items):
        d = hashlib.sha256()
        for name, t in items:
            d.update(str(name).encode())
            d.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        return d.hexdigest()

    out = {"state": h(sorted(mesh_lib.full_state_dict(model).items())),
           "whole": h((n, p) for n, p in model.named_parameters() if not comm.is_split(p))}
    if optimizer is not None:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        out["momentum"] = h((i, mesh_lib.full_tensor(optimizer.state[p]["momentum_buffer"], p))
                            for i, p in enumerate(params) if p in optimizer.state)
    return out


def sh_f32_step(device, mode, opts, seed, strong, weak, grads_path=None, ckpt_dir=None,
                restore_path=None):
    """(c) and (d): one f32 step (TF32 off, every candidate kept) of the
    flagship split as ``mode`` says ("plain": one process) on this data
    rank's rows of ``strong``/``weak``: (losses, the whole gradient that
    enters the optimizer; a rank saves it to ``grads_path`` on rank 0 and
    returns None).  ``ckpt_dir``: then a checkpoint of the state there and
    the digests of the gathered state.  ``restore_path``: the model restored
    from that checkpoint after the step: whether each rank's parts equal
    the file's slices, bit for bit."""
    import torch

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        return sh_f32_run(device, mode, opts, seed, strong, weak, grads_path, ckpt_dir,
                          restore_path)
    finally:  # a rank's later runs in bf16 keep their own settings
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def sh_f32_run(device, mode, opts, seed, strong, weak, grads_path, ckpt_dir, restore_path):
    import torch
    from torch.distributed.tensor import DTensor

    from unit_tpu_torch.checkpoint import Checkpointer, read_checkpoint
    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.parallel import comm
    from unit_tpu_torch.parallel import mesh as mesh_lib
    from unit_tpu_torch.solver import build_optimizer

    cfg = dp_cfg((*opts, *DP_KEEP_ALL_OPTS))

    def build():
        model = flagship_model(cfg, seed, device)
        mesh = None
        if mode != "plain":
            model, mesh = sh_split(model, mode, device)
        solver = build_optimizer(cfg, model)
        n_model = comm.world() if mode == "tp" else 1
        r, n = comm.data_rank(n_model), comm.data_world(n_model)
        rows = len(strong["image"]) // n

        def mine(batch):
            return {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}

        trainer = TrainerNoMeta(model, solver, itertools.repeat(mine(strong)),
                                itertools.repeat(mine(weak)), seed=seed, mesh=mesh,
                                fsdp=mode == "fsdp", tp=mode == "tp")
        trainer.init_state()
        return model, solver, trainer

    model, solver, trainer = build()
    names = [name for name, p in model.named_parameters()]
    by_id = {id(p): name for name, p in model.named_parameters()}
    grads = {}

    def keep(optimizer, args, kwargs):  # the gradient that enters SGD, gathered whole
        for g in optimizer.param_groups:
            for p in g["params"]:
                grads[by_id[id(p)]] = mesh_lib.full_tensor(p.grad, p).clone()

    handle = solver.optimizer.register_step_pre_hook(keep)
    metrics = dict(trainer.run_step())  # resolved on every rank here
    handle.remove()
    out = {"metrics": metrics, "names": names}
    if ckpt_dir is not None:
        Checkpointer(ckpt_dir).save(int(trainer.state.step), trainer.state, wait=True)
        out["digests"] = sh_digests(model, solver.optimizer)
    if restore_path is not None:  # into the same split model: every value is overwritten
        Checkpointer(os.path.dirname(restore_path)).restore(state=trainer.state)
        file = read_checkpoint(restore_path)
        opt = solver.optimizer
        equal = trainer.state.step == file["step"]
        for name, t in itertools.chain(model.named_parameters(), model.named_buffers()):
            local = t.to_local() if isinstance(t, DTensor) else t
            equal &= torch.equal(local.detach().cpu(), mesh_lib.local_part(file["model"][name], t))
        params = [p for g in opt.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            buf = opt.state[p]["momentum_buffer"]
            buf = buf.to_local() if isinstance(buf, DTensor) else buf
            equal &= torch.equal(buf.cpu(), mesh_lib.local_part(
                file["optimizer"]["state"][i]["momentum_buffer"], p))
        out["restored_parts_equal"] = bool(equal)
    if grads_path is None:
        out["grads"] = grads
        out["state"] = trainer.state  # one process: its model, restored into in (d)
    elif comm.is_main():
        torch.save({k: v.cpu() for k, v in grads.items()}, grads_path)
    return out


def sh_rank(device, args):
    """In one rank process, for each mode of ``args`` ({mode: (run_argv,
    f32_args)}): (a) or (b), the run loop, then (c) and (d).  {mode: (run,
    its seconds, f32, the mode's seconds)}; for the mode "pp", (f), (g) and
    (h) (``pp_rank``'s arguments and result, and its seconds), for the mode
    "spatial" (i) and (j) (``sp_rank``'s), for "spatial_other" (k)
    (``sp_other_rank``'s)."""
    import torch

    out = {}
    for mode, mode_args in args.items():
        if mode in ("pp", "spatial", "spatial_other"):
            t = time.perf_counter()
            rank_fn = {"pp": pp_rank, "spatial": sp_rank, "spatial_other": sp_other_rank}[mode]
            out[mode] = rank_fn(device, *mode_args), time.perf_counter() - t
            continue
        run_argv, f32_args = mode_args
        t = time.perf_counter()
        run = dp_run_rank(device, run_argv, sharded=True)
        run_secs = time.perf_counter() - t
        if device.type == "cuda":
            torch.cuda.empty_cache()
        f32 = sh_f32_step(device, mode, *f32_args)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[mode] = run, run_secs, f32, time.perf_counter() - t
    return out


def sh_compare_grads(tag, m1, g1, m2, g2, part="(c)"):
    """(c)'s and (g)'s gate: the split or pipelined step's losses to
    SH_LOSS_RTOL and gradients to phase 8's bound against the one process's."""
    loss_rel = max(abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-12) for k in m1 if k != "data_time")
    big = max(float(g.abs().max()) for g in g1.values())
    over = {n: float((g2[n].to(g1[n].device) - g1[n]).abs().max())
            / (TRAIN_GRAD_REL * float(g1[n].abs().max()) + TRAIN_GRAD_FLOOR * big) for n in g1}
    worst = sorted(over, key=over.get, reverse=True)[:3]
    log(f"[22] {part} {tag}: losses max rel diff {loss_rel:.3g} (tol {SH_LOSS_RTOL}); "
        f"{len(g1)} gradients, worst max|diff|/bound {over[worst[0]]:.3g} (bound "
        f"{TRAIN_GRAD_REL} * max|g_leaf| + {TRAIN_GRAD_FLOOR} * G, G = {big:.4g}): "
        + ", ".join(f"{n} {over[n]:.3g}" for n in worst))
    if set(g2) != set(g1) or loss_rel > SH_LOSS_RTOL or over[worst[0]] > 1.0:
        raise AssertionError(f"the {tag} f32 step is not the one-process step")
    return loss_rel, over[worst[0]]


def sh_restored_digests(path, state):
    """(d): one process restores ``path`` into the whole flagship's ``state``
    (every value overwritten): the digests of its state and momenta."""
    from unit_tpu_torch.checkpoint import Checkpointer

    Checkpointer(os.path.dirname(path)).restore(state=state)
    return sh_digests(state.model, state.solver.optimizer)


# (f)-(h): pipeline parallelism (TPU.PP) as a third mode of the same two
# ranks, stage 0 and stage 1 of one data rank; the hand-off of each map and
# gradient, and the gradient combine, go through the host as gloo's
PP_STAGES = 2
PP_MICRO = 2                 # TPU.GRAD_ACCUM: the micro-batches a step pipelines
PP_IMAGES = 2                # images a micro-batch and stream: the recipe's 4 + 4 a step
PP_WARMUP, PP_STEPS = 1, 2   # then one more step with the hand-off and the combine timed
PP_OPTS = ("TPU.PP", "True", "TPU.PP_STAGES", str(PP_STAGES), "TPU.GRAD_ACCUM", str(PP_MICRO))
PP_RUN_STEPS = 2             # (h): a checkpoint and an evaluation after step 2


def pp_launches(k4, stage, images=PP_IMAGES):
    """The launches of one pipelined step on ``stage`` (2 stages, PP_MICRO
    micro-batches of ``images`` + ``images``), from ``k4`` = (backbone
    FrozenBNs, one Res5 head's, the backbone's behind a trainable conv).
    Their sum over the stages is one process's at GRAD_ACCUM PP_MICRO (K1 2,
    K2 2, K3 1, K4 (backbone + 3 Res5) + (trainable + 2 Res5) a micro-batch),
    plus the backbone's K4 forwards once more: stage 0 recomputes its range
    in backward (remat)."""
    n_backbone, n_res5, n_trainable = k4
    m = PP_MICRO
    if stage == 0:
        return {"roi_align_fwd": 0, "roi_align_bwd": 0, "nms_mask": 0, "nms_mask_images": 0,
                "bn_act_fwd": 2 * m * n_backbone, "bn_act_bwd": m * n_trainable,
                "bn_act_layout_copies": 0}
    return {"roi_align_fwd": 2 * m, "roi_align_bwd": 2 * m, "nms_mask": m,
            "nms_mask_images": 2 * images * m, "bn_act_fwd": 3 * m * n_res5,
            "bn_act_bwd": 2 * m * n_res5, "bn_act_layout_copies": 2 * m}


def pp_trainer(device, cfg, seed, strong, weak, pp=True):
    """The flagship under TPU.PP on the (1, 2) stage mesh (``pp``), or one
    process at GRAD_ACCUM PP_MICRO, over cycles of ``strong`` and ``weak``."""
    from unit_tpu_torch.engine import TrainerNoMeta
    from unit_tpu_torch.parallel import mesh as mesh_lib
    from unit_tpu_torch.solver import build_optimizer

    model = flagship_model(cfg, seed, device)
    mesh = mesh_lib.make_mesh_pp(1, PP_STAGES, device.type) if pp else None
    trainer = TrainerNoMeta(model, build_optimizer(cfg, model), itertools.cycle(strong),
                            itertools.cycle(weak), seed=seed, grad_accum=PP_MICRO, mesh=mesh,
                            pp=pp)
    trainer.init_state()
    return model, trainer


def timed_calls(sync, into, targets):
    """Time each call of ``module.name`` for the (module, name, key) of
    ``targets`` between two device synchronisations, into ``into[key]`` (ms,
    summed) and ``into[key + "_calls"]``; returns the function that
    restores them."""
    real = [(module, name, getattr(module, name)) for module, name, _ in targets]

    def timed(fn, key):
        def call(*a, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            into[key] = into.get(key, 0.0) + (time.perf_counter() - t) * 1e3
            into[key + "_calls"] = into.get(key + "_calls", 0) + 1
            return out
        return call

    for (module, name, fn), (_, _, key) in zip(real, targets):
        setattr(module, name, timed(fn, key))
    return lambda: [setattr(module, name, fn) for module, name, fn in real]


def timed_pipeline_comm(sync, into):
    """Time the pipeline step's hand-off calls (comm.send_map, recv_map,
    send_header, recv_header, wait_all) and its gradient combine
    (comm.all_reduce_mean_tensors) into ``into["handoff"]`` /
    ``into["combine"]`` (``timed_calls``)."""
    from unit_tpu_torch.parallel import comm

    return timed_calls(sync, into, [
        (comm, n, "handoff") for n in ("send_map", "recv_map", "send_header", "recv_header",
                                       "wait_all")] + [(comm, "all_reduce_mean_tensors",
                                                        "combine")])


def pp_train_rank(device, opts, seed, canvases):
    """(f), one stage rank: the flagship under TPU.PP at full width, PP_IMAGES
    + PP_IMAGES images a micro-batch, PP_WARMUP + PP_STEPS steps, then one
    step with the hand-off and the combine timed: the step times, the
    timed step's hand-off and combine ms, peak memory, each step's launches,
    the losses and the state's digest."""
    import torch

    from unit_tpu_torch.parallel import comm

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = dp_cfg((*opts, *PP_OPTS))
    strong, weak = synthetic_train_batches(cfg, seed + 2000, per_stream=PP_IMAGES,
                                           canvases=canvases)
    model, trainer = pp_trainer(device, cfg, seed, strong, weak)
    for _ in range(PP_WARMUP):
        trainer.run_step()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    step_ms, launches = [], []
    for _ in range(PP_STEPS):
        reset_launch_counts()
        t = time.perf_counter()
        trainer.run_step().resolve()  # read now: the clock holds the device's time
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches.append(read_launch_counts())
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    split = {"handoff": 0.0, "combine": 0.0}
    restore = timed_pipeline_comm(sync, split)
    t = time.perf_counter()
    trainer.run_step()
    timed_ms = (time.perf_counter() - t) * 1e3
    restore()
    out = {"rank": comm.rank(), "stage": trainer._stage, "step_ms": step_ms,
           "timed_ms": timed_ms, "split": split, "peak": peak, "launches": launches,
           "k4": frozen_bn_counts(model),
           "losses": [{k: v for k, v in m.items() if k != "data_time"}
                      for m in trainer.metrics_history],
           "finite": all(np.isfinite(v) for m in trainer.metrics_history for v in m.values()),
           "digest": state_digest(model)}
    del trainer, model
    return out


def pp_f32_step(device, opts, seed, micro, pp, grads_path=None):
    """(g): one f32 step (TF32 off, every candidate kept) of the flagship at
    GRAD_ACCUM PP_MICRO on the micro-batches ``micro`` ([(strong, weak)]),
    under TPU.PP at world 2 (``pp``) or in one process: (losses, the
    gradient that enters SGD; under PP rank 0 saves it to ``grads_path``)."""
    import torch

    from unit_tpu_torch.parallel import comm

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        cfg = dp_cfg((*opts, *DP_KEEP_ALL_OPTS, *(PP_OPTS if pp else ())))
        model, trainer = pp_trainer(device, cfg, seed, [s for s, _ in micro],
                                    [w for _, w in micro], pp=pp)
        names = {id(p): name for name, p in model.named_parameters()}
        grads = {}

        def keep(optimizer, args, kwargs):  # the combined gradient, as SGD takes it
            for g in optimizer.param_groups:
                for p in g["params"]:
                    grads[names[id(p)]] = p.grad.detach().clone()

        trainer.optimizer.optimizer.register_step_pre_hook(keep)
        metrics = dict(trainer.run_step())  # resolved on every rank here
        del trainer, model
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    if grads_path is None:
        return metrics, grads
    if comm.is_main():
        torch.save({k: v.cpu() for k, v in grads.items()}, grads_path)
    return metrics, None


def pp_rank(device, opts, seed, canvases, micro, grads_path, run_argv):
    """(f), (g) and (h) in one stage rank: ((f)'s results, (g)'s losses, (h)'s
    run, and each one's seconds)."""
    import torch

    out = []
    for fn, args in ((pp_train_rank, (opts, seed, canvases)),
                     (pp_f32_step, (opts, seed, micro, True, grads_path)),
                     (dp_run_rank, (run_argv,))):
        t = time.perf_counter()
        result = fn(device, *args)
        out.append((result if fn is not pp_f32_step else result[0],
                    time.perf_counter() - t))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_sharded(seed, workdir):
    """Phase 22: FSDP and TP on one card, two gloo ranks on card 0, in one
    spawn.  (a) FSDP at world 2 and (b) TP 2 at world 2 (data 1 x model 2)
    through engine.runner.run on phase 20's JPEG devkit, warm-started from
    phase 21's initial checkpoint of the flagship (bf16, full width): the
    runner builds the mesh, splits the model and builds the solver after.
    (a) 4 + 4 images a rank, 1 warm-up + 3 steps; (b) 1 + 1, 1 + 1 steps.
    Per rank the timed steps' ms, the last one under the profiler with its
    gloo collectives' host ms by name, and their peak memory; every step's
    launches (K1 2, K2 2, K3 1, K4 124 + 103, as one process at the rank's
    images), finite losses equal on both ranks, one gathered state; (a)
    res4's first conv half on each rank; (b) every split kernel half its
    output channels, the parameters no mode splits bit-identical on both
    ranks, and PreciseBN before each evaluation (on the replica, the
    statistics copied back).  An evaluation on a whole replica and a
    checkpoint every SH_RUN_PERIOD steps and at the end: finite AP, the
    ranks' results equal, and under FSDP the device memory an evaluation
    leaves behind (under half the whole model's bytes: the replica is
    dropped), with the peak of the step after it.  (c) f32, TF32 off, every candidate kept:
    FSDP at world 2 (1 + 1 a rank) against one process (2 + 2), TP 2 (1 + 1
    on the data rank) against one process (1 + 1): losses 1e-5, gradients
    phase 8's bound.  (d) the checkpoint of (c)'s FSDP state and of its TP
    state, each restored by one process (state and momenta hash as the
    ranks' gathered state); the one-process (c) checkpoint restored under
    FSDP and under TP (each rank's parts equal the file's slices).  Then
    TPU.PP with 2 stages in the same ranks (``pp_rank``, gated by
    ``pp_checks``): (f) the flagship at full width, 2 micro-batches of 2 + 2
    images; (g) the f32 pipelined step against one process at GRAD_ACCUM
    2; (h) engine.runner.run under PP with a checkpoint and an evaluation
    against a one-process --eval-only.  Then the 2-D (data x spatial) mesh at
    (1, 2) in the same ranks (``sp_rank``, gated by ``sp_checks``): (i) the
    flagship at full width on 2 + 2 images, half the canvas rows a rank;
    (j) its f32 step against (c)'s one process on the same 2 + 2 batch;
    (k) the note and the dock recipes on the mesh in f32 against one
    process's steps (``sp_other_steps``, ``sp_other_checks``).  A
    generator (``phase_multi_rank``): it yields ``sh_rank``'s arguments,
    gets back each rank's result from the shared spawn, and returns {path:
    launch counts}."""
    import torch

    dev = torch.device(RUN_DEVICE)
    on_card = dev.type == "cuda"
    opts = list(RUN_EXTRA_OPTS)
    by_path = {}

    def free():
        if on_card:
            torch.cuda.empty_cache()

    argv, _ = dp_run_argv(seed, workdir, dev, opts)
    cfg32 = dp_cfg((*opts, *DP_KEEP_ALL_OPTS))
    batch = synthetic_train_batches(cfg32, seed + 5, n_batches=1, per_stream=SH_WORLD)
    strong, weak = batch[0][0], batch[1][0]
    one_img = ({k: v[:1] for k, v in strong.items()}, {k: v[:1] for k, v in weak.items()})
    results, args = {}, {}
    for mode, (s, w) in (("fsdp", (strong, weak)), ("tp", one_img)):
        # the one process's f32 step first, and its checkpoint
        one_dir = os.path.join(workdir, f"sh_one_{mode}")
        t = time.perf_counter()
        one = sh_f32_step(dev, "plain", opts, seed, s, w, ckpt_dir=one_dir)
        secs_one = time.perf_counter() - t
        free()
        paths = [os.path.join(workdir, f"sh_{mode}_{x}") for x in ("grads.pt", "ckpt", "run")]
        grads_path, split_dir, run_dir = paths
        images, warmup, steps, mode_opts = SH_MODES[mode]
        data_ranks = 1 if mode == "tp" else SH_WORLD
        args[mode] = (argv(run_dir) + ["SOLVER.IMS_PER_BATCH", str(images * data_ranks),
                                       "SOLVER.MAX_ITER", str(warmup + steps),
                                       "SOLVER.CHECKPOINT_PERIOD", str(SH_RUN_PERIOD),
                                       "TEST.EVAL_PERIOD", str(SH_RUN_PERIOD), *mode_opts],
                      (opts, seed, s, w, grads_path, split_dir,
                       os.path.join(one_dir, "step_1.pt")))
        results[mode] = (one, secs_one, *paths)
    # (g)'s one process, then (f)-(h) as the spawn's third mode
    pp_batch = synthetic_train_batches(cfg32, seed + 6, n_batches=1, per_stream=PP_MICRO)
    micro = [tuple({k: v[i:i + 1] for k, v in b[0].items()} for b in pp_batch)
             for i in range(PP_MICRO)]
    t = time.perf_counter()
    pp_one = pp_f32_step(dev, opts, seed, micro, pp=False)
    secs_pp_one = time.perf_counter() - t
    free()
    pp_grads, pp_run = (os.path.join(workdir, f"sh_pp_{x}") for x in ("grads.pt", "run"))
    args["pp"] = (opts, seed, TRAIN_CANVASES, micro, pp_grads,
                  argv(pp_run) + ["SOLVER.IMS_PER_BATCH", str(PP_IMAGES),
                                  "SOLVER.MAX_ITER", str(PP_RUN_STEPS),
                                  "SOLVER.CHECKPOINT_PERIOD", str(PP_RUN_STEPS),
                                  "TEST.EVAL_PERIOD", str(PP_RUN_STEPS), *PP_OPTS])
    # (i) and (j): the 2-D mesh on (c)'s FSDP batch of 2 + 2 images, whose
    # one-process f32 step (j) is held against
    sp_grads = os.path.join(workdir, "sh_spatial_grads.pt")
    args["spatial"] = (opts, seed, TRAIN_CANVASES, strong, weak, sp_grads)
    # (k): the note and the dock on the 2-D mesh, after their one process's steps
    sp_ones = {}
    for recipe in SP_RECIPES:
        t = time.perf_counter()
        sp_ones[recipe] = (sp_other_steps(dev, recipe, opts, seed, NOTE_CANVASES, False),
                           time.perf_counter() - t)
    args["spatial_other"] = (opts, seed, NOTE_CANVASES)
    # the four modes after phase 21's in the shared spawn: the ranks start and
    # reach the card once
    ranks = yield args
    log(f"[22] the ranks' seconds a mode: "
        f"{[{m: round(r[m][-1], 1) for m in r} for r in ranks]}")
    free()

    # (a) FSDP and (b) TP 2 through the run loop
    for mode, tag, label in (("fsdp", "(a)", "FSDP"), ("tp", "(b)", f"TP {SH_WORLD}")):
        images, warmup, steps, mode_opts = SH_MODES[mode]
        runs = [r[mode][0] for r in ranks]
        run_dir = results[mode][-1]
        a, b = runs
        k4_fwd, k4_bwd = a["k4"]
        want = {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1,
                "nms_mask_images": 2 * images, "bn_act_fwd": k4_fwd, "bn_act_bwd": k4_bwd,
                "bn_act_layout_copies": 2}
        for r in runs:
            timed = r["step_ms"][warmup:]
            log(f"[22] {tag} {label} rank {r['rank']}: engine.runner.run, {steps} timed steps "
                f"of {images} + {images} images after {warmup} warm-up: median "
                f"{np.median(timed):.2f} ms (min {min(timed):.2f}, max {max(timed):.2f}); "
                + (f"peak device memory of the timed steps "
                   f"{max(m['peak'] for m in r['memory'][warmup:]) / 2**30:.2f} GiB; "
                   if on_card else "")
                + f"{len(r['split'])} parameters split; launches a step {r['launches'][-1]}; "
                f"total_loss {[round(m['total_loss'], 4) for m in r['losses'].values()]}")
            if on_card and len(r["memory"]) > SH_RUN_PERIOD:
                # the step after the first evaluation against the one before it
                before, after = r["memory"][SH_RUN_PERIOD - 1], r["memory"][SH_RUN_PERIOD]
                left = after["start"] - before["end"]
                log(f"[22] {tag} {label} rank {r['rank']}: device memory allocated after step "
                    f"{SH_RUN_PERIOD} {before['end'] / 2**30:.3f} GiB, after its evaluation "
                    f"{after['start'] / 2**30:.3f} GiB (left behind {left / 2**20:.1f} MiB; the "
                    f"whole model {r['whole_bytes'] / 2**20:.1f} MiB); peak of the evaluation "
                    f"{after['hooks_peak'] / 2**30:.2f} GiB; peak of step {SH_RUN_PERIOD} "
                    f"{before['peak'] / 2**30:.2f} GiB, of step {SH_RUN_PERIOD + 1} after the "
                    f"evaluation {after['peak'] / 2**30:.2f} GiB")
                if not left < r["whole_bytes"] / 2:
                    raise AssertionError(f"an evaluation under {label} left {left} bytes on "
                                         f"the card: its whole replica was kept")
        written = sorted(os.listdir(run_dir))
        ap = a["results"]["bbox"]
        dets, images_seen = a["merged"][-1]
        leaf = [r["split"].get(SH_FSDP_LEAF) for r in runs]
        halves = all(2 * local == whole for r in runs for local, whole in r["split"].values())
        bn = "TEST.PRECISE_BN.ENABLED" in mode_opts
        log(f"[22] {tag} {label}: the run and (c), (d) {max(r[mode][3] for r in ranks):.1f} s of "
            f"the spawn, the run {max(r[mode][1] for r in ranks):.1f} s; "
            + (f"{SH_FSDP_LEAF} {leaf} (local, whole) elements; " if mode == "fsdp" else
               f"every split parameter half on each rank {halves}; the parameters no mode "
               f"splits bit-identical on both ranks "
               f"{a['digests']['whole'] == b['digests']['whole']}; ")
            + f"the gathered states' hash equal {a['digests']['state'] == b['digests']['state']}; "
            f"{len(a['merged'])} evaluations on a whole replica (the last {len(dets)} "
            f"detections of {len(images_seen)} images): AP50 {ap['AP50']:.6g}, AP "
            f"{ap['AP']:.6g}, the ranks' results equal "
            f"{strip_results(a['results']) == strip_results(b['results'])}; PreciseBN "
            f"refreshes {a['refreshes']}, the FrozenBN statistics changed "
            f"{a['buffers_changed']}; OUTPUT_DIR holds {written}")
        if not all(r["finite"] for r in runs) or a["losses"] != b["losses"] \
                or a["digests"]["state"] != b["digests"]["state"] \
                or any(len(r["launches"]) != warmup + steps for r in runs):
            raise AssertionError(f"the {label} ranks' states or losses differ, or a loss is "
                                 f"not finite")
        if mode == "fsdp" and any(x is None or 2 * x[0] != x[1] for x in leaf):
            raise AssertionError(f"{SH_FSDP_LEAF} is not split in half over the ranks: {leaf}")
        if mode == "tp" and not (halves and len(a["split"]) >= 2
                                 and a["digests"]["whole"] == b["digests"]["whole"]):
            raise AssertionError("TP did not split the kernels, or its ranks differ")
        # PreciseBN's statistics of one batch leave the random detector no
        # box above the test threshold: detections are gated without it
        if not np.isfinite(ap["AP50"]) \
                or strip_results(a["results"]) != strip_results(b["results"]) \
                or not {f"step_{SH_RUN_PERIOD}.pt", "metrics.json"} <= set(written) \
                or (len(dets) == 0 and not bn):
            raise AssertionError(f"the {label} run loop did not evaluate and checkpoint alike "
                                 f"on both ranks")
        if any((r["refreshes"], r["buffers_changed"]) != (
                (warmup + steps) // SH_RUN_PERIOD if bn else 0, bn) for r in runs):
            raise AssertionError(f"PreciseBN under {label} did not refresh the statistics "
                                 f"once an evaluation and copy them back, or they moved "
                                 f"without it")
        if on_card and any(c != want for r in runs for c in r["launches"]):
            raise AssertionError(f"a {label} rank did not launch {want} in a step: "
                                 f"{[r['launches'] for r in runs]}")
        for r in runs:
            by_path[f"{mode}_train_rank{r['rank']}"] = {
                k: sum(c[k] for c in r["launches"][warmup:]) for k in want}
        shutil.rmtree(run_dir, ignore_errors=True)

    # (c) f32 against one process, and (d) the checkpoints
    for mode, tag in (
            ("fsdp", "FSDP at world 2 (1 + 1 a rank) against one process (2 + 2)"),
            ("tp", "TP 2 at world 2 (1 + 1 on the data rank) against one process (1 + 1)")):
        one, secs_one, path, ckpt_dir, _ = results[mode]
        f32 = [r[mode][2] for r in ranks]
        g2 = torch.load(path, map_location=dev, weights_only=True)
        os.remove(path)
        sh_compare_grads(f"{tag}, the one process {secs_one:.1f} s", one["metrics"],
                         one["grads"], f32[0]["metrics"], g2)
        del g2
        free()
        restored = sh_restored_digests(os.path.join(ckpt_dir, "step_1.pt"), one.pop("state"))
        gathered = f32[0]["digests"]
        parts = [c["restored_parts_equal"] for c in f32]
        log(f"[22] (d) {tag.split(' (')[0]}: its checkpoint restored by one process, state "
            f"and momenta bit-identical to the ranks' gathered ones "
            f"{restored['state'] == gathered['state']} and "
            f"{restored['momentum'] == gathered['momentum']}; the one-process checkpoint "
            f"restored at world 2, each rank's parts the file's slices {parts}")
        if restored["state"] != gathered["state"] or restored["momentum"] != gathered[
                "momentum"] or not all(parts):
            raise AssertionError("a checkpoint did not move between the topologies intact")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        free()
    by_path.update(pp_checks([r["pp"] for r in ranks], pp_one, secs_pp_one, pp_grads, pp_run,
                             argv, dev))
    one, secs_one = results["fsdp"][:2]
    by_path.update(sp_checks([r["spatial"] for r in ranks], one, secs_one, sp_grads, dev))
    by_path.update(sp_other_checks([r["spatial_other"][0] for r in ranks], sp_ones))
    return by_path


def pp_checks(ranks, one, secs_one, grads_path, run_dir, argv, dev):
    """(f)-(h)'s gates on the two stage ranks' results (``pp_rank``'s, with
    its seconds); ``one``: (g)'s one process.  Returns {path: launches}."""
    import torch

    on_card = dev.type == "cuda"
    by_path = {}
    f = [r[0][0][0] for r in ranks]
    for r, (_, secs) in zip(f, (r[0][0] for r in ranks)):
        log(f"[22] (f) PP rank {r['rank']} (stage {r['stage']}): {PP_STEPS} timed steps of "
            f"{PP_MICRO} micro-batches of {PP_IMAGES} + {PP_IMAGES} images after {PP_WARMUP} "
            f"warm-up: median {np.median(r['step_ms']):.2f} ms (min {min(r['step_ms']):.2f}, "
            f"max {max(r['step_ms']):.2f}); one more step with each call synchronised "
            f"{r['timed_ms']:.2f} ms, of it in the hand-off calls (copies through the host and "
            f"the wait for the other stage) {r['split']['handoff']:.2f} ms and in the gradient "
            f"combine (gloo all-reduce through the host) {r['split']['combine']:.2f} ms; "
            + (f"peak device memory of the timed steps {r['peak'] / 2**30:.2f} GiB; "
               if on_card else "")
            + f"launches a step {r['launches'][-1]}; total_loss "
            f"{[round(m['total_loss'], 4) for m in r['losses']]}; {secs:.1f} s with the build")
    summed = {k: sum(r["launches"][-1][k] for r in f) for k in f[0]["launches"][-1]}
    n_backbone = f[0]["k4"][0]
    alone = dict(summed, bn_act_fwd=summed["bn_act_fwd"] - PP_MICRO * n_backbone)
    log(f"[22] (f) launches a step over the two stages {summed}: one process's at GRAD_ACCUM "
        f"{PP_MICRO} {alone} and the backbone's {PP_MICRO} x {n_backbone} K4 forwards again "
        f"(stage 0 recomputes its range in backward); the states' hash equal "
        f"{f[0]['digest'] == f[1]['digest']}")
    if not all(r["finite"] for r in f) or f[0]["losses"] != f[1]["losses"] \
            or f[0]["digest"] != f[1]["digest"] or {r["stage"] for r in f} != {0, 1}:
        raise AssertionError("the PP ranks' states or losses differ, or a loss is not finite")
    if on_card and any(c != pp_launches(r["k4"], r["stage"]) for r in f for c in r["launches"]):
        raise AssertionError(f"a PP stage did not launch {[pp_launches(r['k4'], r['stage']) for r in f]} "
                             f"a step: {[r['launches'] for r in f]}")
    for r in f:
        by_path[f"pp_train_stage{r['stage']}"] = {
            k: sum(c[k] for c in r["launches"]) for k in r["launches"][0]}

    # (g) f32: the pipelined step against one process's accumulated step
    g2 = torch.load(grads_path, map_location=dev, weights_only=True)
    os.remove(grads_path)
    sh_compare_grads(f"PP at world 2 ({PP_MICRO} micro-batches of 1 + 1) against one process "
                     f"at GRAD_ACCUM {PP_MICRO}, the one process {secs_one:.1f} s",
                     one[0], one[1], ranks[0][0][1][0], g2, part="(g)")
    del g2
    if on_card:
        torch.cuda.empty_cache()

    # (h) engine.runner.run under PP on phase 20's devkit of JPEG files
    (a, secs_a), (b, _) = ranks[0][0][2], ranks[1][0][2]
    written = sorted(os.listdir(run_dir))
    ap = a["results"]["bbox"]
    log(f"[22] (h) engine.runner.run under PP ({PP_RUN_STEPS} steps of {PP_MICRO} micro-batches "
        f"of {PP_IMAGES} + {PP_IMAGES} images through the C loader, a checkpoint and an "
        f"evaluation at {PP_RUN_STEPS}) in {secs_a:.1f} s: stages {a['stage']}, {b['stage']}; "
        f"AP50 {ap['AP50']:.6g}, AP {ap['AP']:.6g}, the ranks' results equal "
        f"{strip_results(a['results']) == strip_results(b['results'])}, states equal "
        f"{a['digest'] == b['digest']}; OUTPUT_DIR holds {written}; launches a step "
        f"{[r['launches'][-1] for r in (a, b)]}")
    if a["digest"] != b["digest"] or strip_results(a["results"]) != strip_results(
            b["results"]) or not {f"step_{PP_RUN_STEPS}.pt", "metrics.json"} <= set(written):
        raise AssertionError("the PP ranks' runs differ, or a checkpoint is missing")
    if on_card and any(c != pp_launches(r["frozen_bn"], r["stage"]) for r in (a, b)
                       for c in r["launches"]):
        raise AssertionError(f"a PP run-loop step did not launch its stage's share: "
                             f"{[r['launches'] for r in (a, b)]}")
    for r in (a, b):
        by_path[f"pp_run_stage{r['stage']}"] = {
            k: sum(c[k] for c in r["launches"]) for k in r["launches"][0]}
    check_eval_alone("[22] (h)", f"step-{PP_RUN_STEPS}",
                     argv(run_dir, "--eval-only", "--resume"), ap, a["merged"][-1])
    shutil.rmtree(run_dir, ignore_errors=True)
    return by_path


# (i)-(j): the 2-D (data x spatial) mesh at (1, 2) in the same two ranks:
# each holds half the canvas rows; the halo rows of the stem, the max pool and
# every 3x3 convolution, the gather of the stride-16 map and the gradient's
# all-reduce go through the host as gloo's
SP_IMAGES = 2                # 2 + 2 images a step: phase 7's flagship step
SP_WARMUP, SP_STEPS = 1, 3   # then one more step with its collectives timed


def sp_mesh_step(device, cfg, seed):
    """(model, its solver, the (1, 2) mesh, the 2-D train step) of the
    flagship, rank 0's weights on both ranks."""
    from unit_tpu_torch.engine import make_train_step
    from unit_tpu_torch.parallel import comm
    from unit_tpu_torch.parallel import mesh as mesh_lib
    from unit_tpu_torch.solver import build_optimizer

    model = flagship_model(cfg, seed, device).train()
    comm.broadcast_module(model)
    mesh = mesh_lib.make_mesh_2d(1, comm.world(), device.type)
    solver = build_optimizer(cfg, model)
    step = make_train_step(model, solver.optimizer, solver.scheduler, solver.clip, mesh=mesh)
    return model, solver, mesh, step


def sp_part(mesh, batch, device):
    """This rank's ``shard_batch_spatial`` part of a numpy batch, on ``device``."""
    import torch

    from unit_tpu_torch.parallel import mesh as mesh_lib

    return {k: torch.as_tensor(v).to(device)
            for k, v in mesh_lib.shard_batch_spatial(mesh, batch).items()}


def sp_run_step(step, strong, weak, device, seed, k):
    """Step ``k`` (its generator seeded as one process's, data rank 0) and its
    losses averaged over the ranks, fetched once."""
    import torch

    from unit_tpu_torch.engine.train import step_seed
    from unit_tpu_torch.parallel import comm

    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, k))
    losses = step(strong, weak, gen)
    values = comm.all_reduce_mean(torch.stack(list(losses.values())).float()).tolist()
    return dict(zip(losses, values))


def sp_halo_calls(model):
    """The halo exchanges of one 2-D step: forward the stem, the max pool and
    each block's 3x3 conv; backward each 3x3 conv whose input needs a
    gradient (behind the first trainable convolution)."""
    blocks = [getattr(stage, f"block{i}") for stage in (model.backbone.res2, model.backbone.res3,
                                                        model.backbone.res4)
              for i in range(stage.num_blocks)]
    grad = model.backbone.stem_conv1.weight.requires_grad
    backward = 0
    for block in blocks:
        grad = grad or block.conv1.weight.requires_grad
        backward += grad
    return 2 + len(blocks), backward


def sp_train_rank(device, opts, seed, canvases):
    """(i), one rank: the flagship at full width on the (1, 2) mesh, 2 + 2
    images a step of which it holds half the rows, SP_WARMUP + SP_STEPS
    steps, then one step with its halo exchanges, the map's gather (and its
    backward) and the gradient all-reduce timed: the step times, those ms
    and calls, peak memory, each step's launches, the losses and the
    state's digest."""
    import torch

    from unit_tpu_torch.parallel import comm, spatial

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = dp_cfg(opts)
    model, _, mesh, step = sp_mesh_step(device, cfg, seed)
    strong, weak = synthetic_train_batches(cfg, seed + 3000, per_stream=SP_IMAGES,
                                           canvases=canvases)
    batches = [(sp_part(mesh, s, device), sp_part(mesh, w, device)) for s, w in zip(strong, weak)]
    losses = []

    def run():
        s, w = batches[len(losses) % len(batches)]
        losses.append(sp_run_step(step, s, w, device, seed, len(losses)))

    for _ in range(SP_WARMUP):
        run()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    step_ms, launches = [], []
    for _ in range(SP_STEPS):
        reset_launch_counts()
        t = time.perf_counter()
        run()
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches.append(read_launch_counts())
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    split = {}
    restore = timed_calls(sync, split, [
        (spatial, "_exchange", "halo"), (spatial, "_gather", "gather"),
        (spatial, "_scatter_sum", "gather_backward"), (comm, "all_reduce_mean_tensors",
                                                       "all_reduce")])
    t = time.perf_counter()
    run()
    timed_ms = (time.perf_counter() - t) * 1e3
    restore()
    out = {"rank": comm.rank(), "step_ms": step_ms, "timed_ms": timed_ms, "split": split,
           "peak": peak, "launches": launches, "k4": frozen_bn_counts(model),
           "halo_calls": sp_halo_calls(model), "band": tuple(batches[0][0]["image"].shape),
           "losses": losses, "finite": all(np.isfinite(v) for m in losses for v in m.values()),
           "digest": state_digest(model)}
    del model, step, batches
    return out


def sp_f32_step(device, opts, seed, strong, weak, grads_path):
    """(j): one f32 step (TF32 off, every candidate kept) of the flagship on
    the (1, 2) mesh over the 2 + 2 batch ``strong``/``weak``: its losses;
    rank 0 saves the gradient that enters SGD to ``grads_path``."""
    import torch

    from unit_tpu_torch.parallel import comm

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        cfg = dp_cfg((*opts, *DP_KEEP_ALL_OPTS))
        model, solver, mesh, step = sp_mesh_step(device, cfg, seed)
        names = {id(p): name for name, p in model.named_parameters()}
        grads = {}

        def keep(optimizer, args, kwargs):  # the world's mean, as SGD takes it
            for g in optimizer.param_groups:
                for p in g["params"]:
                    grads[names[id(p)]] = p.grad.detach().clone()

        solver.optimizer.register_step_pre_hook(keep)
        metrics = sp_run_step(step, sp_part(mesh, strong, device), sp_part(mesh, weak, device),
                              device, seed, 0)
        del model, step
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    if comm.is_main():
        torch.save({k: v.cpu() for k, v in grads.items()}, grads_path)
    return metrics


def sp_rank(device, opts, seed, canvases, strong, weak, grads_path):
    """(i) and (j) in one rank: [((i)'s results, seconds), ((j)'s losses, seconds)]."""
    import torch

    out = []
    for fn, args in ((sp_train_rank, (opts, seed, canvases)),
                     (sp_f32_step, (opts, seed, strong, weak, grads_path))):
        t = time.perf_counter()
        out.append((fn(device, *args), time.perf_counter() - t))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def sp_checks(ranks, one, secs_one, grads_path, dev):
    """(i)-(j)'s gates on the two ranks' results (``sp_rank``'s, with its
    seconds); ``one``: (c)'s one-process f32 step on the same 2 + 2 batch.
    Returns {path: launches}."""
    import torch

    on_card = dev.type == "cuda"
    by_path = {}
    runs = [r[0][0][0] for r in ranks]
    for r, (_, secs) in zip(runs, (r[0][0] for r in ranks)):
        split = r["split"]
        log(f"[22] (i) 2-D rank {r['rank']} (spatial {r['rank']} of 2, its band of the images "
            f"{r['band']}): {SP_STEPS} timed steps of {SP_IMAGES} + {SP_IMAGES} images after "
            f"{SP_WARMUP} warm-up: median {np.median(r['step_ms']):.2f} ms (min "
            f"{min(r['step_ms']):.2f}, max {max(r['step_ms']):.2f}); one more step with each "
            f"collective synchronised {r['timed_ms']:.2f} ms, of it the halo exchanges "
            f"{split.get('halo', 0.0):.2f} ms ({split.get('halo_calls', 0)} calls, forward and "
            f"backward), the map's gather {split.get('gather', 0.0):.2f} ms and its backward "
            f"{split.get('gather_backward', 0.0):.2f} ms, the gradient all-reduce "
            f"{split.get('all_reduce', 0.0):.2f} ms; "
            + (f"peak device memory of the timed steps {r['peak'] / 2**30:.2f} GiB; "
               if on_card else "")
            + f"launches a step {r['launches'][-1]}; total_loss "
            f"{[round(m['total_loss'], 4) for m in r['losses']]}; {secs:.1f} s with the build")
    n_backbone, n_res5, n_trainable = runs[0]["k4"]
    want = {"roi_align_fwd": 2, "roi_align_bwd": 2, "nms_mask": 1,
            "nms_mask_images": 2 * SP_IMAGES, "bn_act_fwd": n_backbone + 3 * n_res5,
            "bn_act_bwd": n_trainable + 2 * n_res5, "bn_act_layout_copies": 2}
    halo = sum(runs[0]["halo_calls"])
    log(f"[22] (i) launches a step on each rank as one process's at 2 + 2 {want} (the "
        f"backbone's K4 on half-height bands); halo exchanges a step {runs[0]['halo_calls']} "
        f"(forward, backward); the states' hash equal {runs[0]['digest'] == runs[1]['digest']}")
    if not all(r["finite"] for r in runs) or runs[0]["losses"] != runs[1]["losses"] \
            or runs[0]["digest"] != runs[1]["digest"]:
        raise AssertionError("the 2-D ranks' states or losses differ, or a loss is not finite")
    if any(r["split"].get("halo_calls") != halo for r in runs):
        raise AssertionError(f"a 2-D rank did not exchange {halo} halos in a step: "
                             f"{[r['split'].get('halo_calls') for r in runs]}")
    if on_card and any(c != want for r in runs for c in r["launches"]):
        raise AssertionError(f"a 2-D rank did not launch {want} a step: "
                             f"{[r['launches'] for r in runs]}")
    for r in runs:
        by_path[f"spatial_train_rank{r['rank']}"] = {
            k: sum(c[k] for c in r["launches"]) for k in want}

    # (j) f32: the 2-D step against one process on the same batch
    g2 = torch.load(grads_path, map_location=dev, weights_only=True)
    os.remove(grads_path)
    sh_compare_grads(f"the 2-D step at (1, 2) (half the rows a rank) against one process "
                     f"(2 + 2), the one process {secs_one:.1f} s, the ranks "
                     f"{ranks[0][0][1][1]:.1f} s", one["metrics"], one["grads"],
                     ranks[0][0][1][0], g2, part="(j)")
    del g2
    if on_card:
        torch.cuda.empty_cache()
    return by_path


# (k): the 2-D mesh at (1, 2) over the note (InceptionResNetV2) and the dock
# (VGG-CNN-F) recipes at full width, in f32 (TF32 off, every candidate
# kept): 1 + 2 steps of 2 + 2 images, each rank holding half the canvas rows;
# their unpadded strided ops leave bands of unequal height
SP_RECIPES = ("note", "dock")
SP_OTHER_STEPS = 3  # a warm-up, a timed step, a step with its collectives timed
SP_OTHER_RTOL = 1e-5


def sp_other_setup(recipe, opts, seed, note_canvases):
    """(cfg, its 2 seeded (strong, weak) numpy batches of 2 + 2 images in both
    orientations) of the note (on ``note_canvases``) or the dock recipe (on
    its largest train canvas), the dock's with seeded MCG-style proposals for
    both streams; the same in every process."""
    import runpy

    from unit_tpu_torch.config import get_cfg
    from unit_tpu_torch.data.transforms import TransformConfig

    cfg = get_cfg()
    cfg.merge_from_file(str(NOTE_RECIPE if recipe == "note" else DOCK_RECIPE))
    cfg.merge_from_list([*opts, *DP_KEEP_ALL_OPTS])
    if recipe == "note":
        return cfg, list(zip(*synthetic_train_batches(cfg, seed + 5100, n_batches=2,
                                                      canvases=note_canvases)))
    canvas = TransformConfig.train_from_cfg(cfg).canvas
    short = max(cfg.INPUT.MIN_SIZE_TRAIN)
    content = (short, min(int(round(short * 4 / 3)), cfg.INPUT.MAX_SIZE_TRAIN))
    writer = runpy.run_path(str(ROOT / "scripts" / "make_shapes_proposals_torch.py"))
    strong, weak = with_dock_proposals(
        writer["mcg_like_proposals"], np.random.RandomState(seed + 5200),
        *synthetic_train_batches(cfg, seed + 5200, n_batches=2,
                                 canvases=((canvas, content), (canvas[::-1], content[::-1]))),
        cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN)
    return cfg, list(zip(strong, weak))


def sp_other_steps(device, recipe, opts, seed, note_canvases, mesh_2d):
    """SP_OTHER_STEPS f32 steps (TF32 off) of ``recipe`` at full width, on
    the (1, 2) mesh (``mesh_2d``: each rank its band of the rows) or in one
    process on the whole batches: the losses (the ranks' mean), each step's
    launches and ms, the last step's collectives' ms and calls (on the
    mesh), the peak memory of the last two, the state's digest."""
    import torch

    from unit_tpu_torch.engine import make_train_step
    from unit_tpu_torch.parallel import comm, spatial
    from unit_tpu_torch.solver import build_optimizer

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        cfg, batches = sp_other_setup(recipe, opts, seed, note_canvases)
        if mesh_2d:
            model, _, mesh, step = sp_mesh_step(device, cfg, seed)
            batches = [(sp_part(mesh, s, device), sp_part(mesh, w, device)) for s, w in batches]
        else:
            model = flagship_model(cfg, seed, device).train()
            solver = build_optimizer(cfg, model)
            step = make_train_step(model, solver.optimizer, solver.scheduler, solver.clip)
            batches = [tuple({k: torch.as_tensor(v).to(device) for k, v in b.items()}
                             for b in pair) for pair in batches]
        out = {"rank": comm.rank(), "losses": [], "launches": [], "step_ms": [], "split": {},
               "band": tuple(batches[0][0]["image"].shape)}
        restore = None
        for k in range(SP_OTHER_STEPS):
            if k == 1 and on_card:
                torch.cuda.reset_peak_memory_stats(device)
            if k == SP_OTHER_STEPS - 1 and mesh_2d:
                restore = timed_calls(sync, out["split"], [
                    (spatial, "_exchange", "halo"), (spatial, "_gather", "gather"),
                    (spatial, "_scatter_sum", "gather_backward")])
            sync()
            before = read_launch_counts()
            t = time.perf_counter()
            out["losses"].append(sp_run_step(step, *batches[k % len(batches)], device, seed, k))
            out["step_ms"].append((time.perf_counter() - t) * 1e3)
            out["launches"].append({n: v - before[n] for n, v in read_launch_counts().items()})
        if restore is not None:
            restore()
        out.update(peak=torch.cuda.max_memory_allocated(device) if on_card else 0,
                   digest=state_digest(model))
        del model, step, batches
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    if on_card:
        torch.cuda.empty_cache()
    return out


def sp_other_rank(device, opts, seed, note_canvases):
    """(k) in one rank: {recipe: (``sp_other_steps`` on the mesh, seconds)}."""
    out = {}
    for recipe in SP_RECIPES:
        t = time.perf_counter()
        out[recipe] = (sp_other_steps(device, recipe, opts, seed, note_canvases, True),
                       time.perf_counter() - t)
    return out


def sp_other_checks(ranks, ones):
    """(k)'s gates: each recipe's ranks against its one process (``ones``:
    {recipe: (``sp_other_steps`` in one process, seconds)}): every step's
    losses within SP_OTHER_RTOL, each step's launches a rank equal to the one
    process's, one state on both ranks.  Returns {path: launches}."""
    by_path = {}
    for recipe in SP_RECIPES:
        one, secs_one = ones[recipe]
        runs = [r[recipe][0] for r in ranks]
        secs = max(r[recipe][1] for r in ranks)
        for r in runs:
            split = r["split"]
            log(f"[22] (k) {recipe} on the 2-D mesh, rank {r['rank']} (its band of the images "
                f"{r['band']}): f32 steps of 2 + 2 images {[round(v, 1) for v in r['step_ms']]} "
                f"ms (a warm-up, a step, a step with each collective synchronised: the halo "
                f"exchanges {split.get('halo', 0.0):.2f} ms in {split.get('halo_calls', 0)} "
                f"calls, forward and backward, the map's gather {split.get('gather', 0.0):.2f} "
                f"ms and its backward {split.get('gather_backward', 0.0):.2f} ms); peak device "
                f"memory {r['peak'] / 2**30:.2f} GiB; launches a step {r['launches'][-1]}")
        rel = max(abs(r["losses"][k][n] - v) / max(abs(v), 1e-12) for r in runs
                  for k, m in enumerate(one["losses"]) for n, v in m.items())
        same_launches = all(r["launches"] == one["launches"] for r in runs)
        same_state = runs[0]["digest"] == runs[1]["digest"]
        log(f"[22] (k) {recipe}: against one process on the whole 2 + 2 images ({secs_one:.1f} "
            f"s; its steps {[round(v, 1) for v in one['step_ms']]} ms, peak "
            f"{one['peak'] / 2**30:.2f} GiB), the ranks {secs:.1f} s with the build: every "
            f"step's losses max rel diff {rel:.3g} (tol {SP_OTHER_RTOL}); launches a step equal "
            f"{same_launches} ({one['launches'][-1]}); the ranks' states' hash equal "
            f"{same_state}; total_loss {[round(m['total_loss'], 5) for m in runs[0]['losses']]}")
        if not (rel <= SP_OTHER_RTOL and same_launches and same_state
                and all(np.isfinite(v) for m in one["losses"] for v in m.values())):
            raise AssertionError(f"the {recipe} recipe on the 2-D mesh is not one process's "
                                 f"step")
        by_path[f"spatial_{recipe}_rank0"] = {
            k: sum(c[k] for c in runs[0]["launches"]) for k in runs[0]["launches"][0]}
    return by_path


def multi_rank(device, dp_args, sh_args):
    """One rank of the spawn phases 21 and 22 share: ``dp_all_rank(
    *dp_args)`` with its seconds, then ``sh_rank(sh_args)``."""
    import torch

    # phase 21's f32 step turns TF32 off and cuDNN deterministic for its run
    # loop after it; phase 22's ranks start from a fresh process's settings
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    t = time.perf_counter()
    dp = dp_all_rank(device, *dp_args)
    secs = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.empty_cache()
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = flags
    return (dp, secs), sh_rank(device, sh_args)


def phase_multi_rank(seed, workdir):
    """Phases 21 and 22 in one spawn of two gloo ranks on card 0, so that the
    ranks start and reach the card once: each phase runs its one-process
    parts and yields its ranks' arguments, the ranks run phase 21's
    functions and then phase 22's, and each phase then checks its ranks'
    results.  Returns {path: launch counts}."""
    import torch

    from unit_tpu_torch.parallel import launch

    on_card = RUN_DEVICE == "cuda"
    devices = [0] * DP_WORLD if on_card else ["cpu"] * DP_WORLD
    phases = {21: phase_data_parallel(seed, workdir), 22: phase_sharded(seed, workdir)}
    t = time.perf_counter()
    dp_args, sh_args = (next(p) for p in phases.values())
    log(f"[21-22] the one-process parts in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ranks = launch(multi_rank, DP_WORLD, devices, "gloo", args=(dp_args, sh_args),
                   timeout=DP_TIMEOUT + SH_TIMEOUT)
    log(f"[21-22] one spawn of {DP_WORLD} ranks for phases 21 and 22: "
        f"{time.perf_counter() - t:.1f} s (the start, then 21's (a), (b) and (c), then 22's "
        f"modes)")
    if on_card:
        torch.cuda.empty_cache()
    by_path = {}
    for (number, phase), results in zip(phases.items(), zip(*ranks)):
        t = time.perf_counter()
        try:
            phase.send(list(results))
        except StopIteration as done:
            by_path.update(done.value)
        else:
            raise AssertionError(f"phase {number} yielded twice")
        log(f"[{number}] its checks in {time.perf_counter() - t:.1f} s")
    return by_path


def strip_results(results):
    return {k: v for k, v in results.items() if k != "inference_seconds_per_image"}


def count_calls(module, name):
    """Count the calls of ``module.name`` (restore ``calls["real"]`` after)."""
    calls = {"n": 0, "real": getattr(module, name)}

    def counted(*a, **kw):
        calls["n"] += 1
        return calls["real"](*a, **kw)

    setattr(module, name, counted)
    return calls


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
    seconds = {}

    def timed(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[label] = round(time.perf_counter() - t, 1)
        return out

    card = phase_env()
    timed(1, phase_build)
    rng = np.random.RandomState(args.seed)
    k1 = timed(2, phase_k1, rng)
    k3 = timed(3, phase_k3, rng)
    cfg = get_cfg()
    cfg.merge_from_file(str(FLAGSHIP))
    by_path = {"serving": timed(4, phase_e2e, cfg, args.seed)}
    timed(5, phase_whole_path, cfg, args.seed)
    k2 = timed(6, phase_k2, rng)
    by_path["train"] = timed(7, phase_train, cfg, args.seed)
    timed(8, phase_train_whole_path, cfg, args.seed)
    k4 = timed(9, phase_k4, rng)
    with tempfile.TemporaryDirectory(prefix="unit_tpu_torch_run_") as workdir:
        by_path["run_loop"] = launches = timed(10, phase_run_loop, cfg, args.seed, workdir)
        by_path["finetune"] = timed(11, phase_finetune, cfg, args.seed, workdir)
        coco_paths, k1_mask = timed(12, phase_coco_segm, args.seed, workdir)
        by_path.update(coco_paths)
        weak_paths, k3_b2 = timed(13, phase_weak_variants, args.seed, workdir)
        by_path.update(weak_paths)
        meta_paths, k1_support = timed(14, phase_meta, args.seed, workdir)
        by_path.update(meta_paths)
        tta_paths, k1_tta, k3_tta = timed(15, phase_tta, cfg, args.seed, workdir)
        by_path.update(tta_paths)
        note_paths, k1_note, k2_note, k3_note = timed(16, phase_note, args.seed, workdir)
        by_path.update(note_paths)
        dock_paths, k3_dock = timed(17, phase_dock, args.seed, workdir)
        by_path.update(dock_paths)
        by_path.update(timed(18, phase_serving, cfg, args.seed, workdir))
        trained_paths, k3_trained = timed(19, phase_trained, cfg, args.seed, workdir)
        by_path.update(trained_paths)
        by_path.update(timed(20, phase_host_wire, cfg, args.seed, workdir))
        pair_paths, k1_pairs, k2_pairs, k4_pairs = timed(23, phase_pairs, args.seed, workdir)
        by_path.update(pair_paths)
        by_path.update(timed("21-22", phase_multi_rank, args.seed, workdir))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; seconds a "
        f"phase {seconds}")

    def per_path(*names):
        return {path: sum(counts[n] for n in names) for path, counts in by_path.items()}

    # every kernel of a path was launched on it, but for the kernels a path
    # does not run: serving no backward (VOC, COCO and WeakRCNN requests),
    # the VOC fine-tune recipe neither (its freeze lists hold the backbone and
    # box_head), the COCO one none through ROIAlign (it trains box_head behind
    # a frozen backbone); the note recipe no K4 (InceptionResNetV2 and its
    # tail have no FrozenBN); the dock recipe pools with ROIPool (no K1 or
    # K2) and has no FrozenBN (no K4), and where its batches carry proposals
    # no RPN runs: its train steps with proposal files launch no kernel at all
    no_k4 = ("bn_act_fwd", "bn_act_bwd")
    no_k1_k2_k4 = ("roi_align_fwd", "roi_align_bwd") + no_k4
    no_kernel = no_k1_k2_k4 + ("nms_mask", "nms_mask_images")
    not_run = {"serving": ("roi_align_bwd", "bn_act_bwd"),
               "finetune": ("roi_align_bwd", "bn_act_bwd"),
               "coco_segm": ("roi_align_bwd", "bn_act_bwd"),
               "coco_segm_ft": ("roi_align_bwd",),
               "weak_rcnn_serving": ("roi_align_bwd", "bn_act_bwd"),
               "tta": ("roi_align_bwd", "bn_act_bwd"),
               "note_serving": ("roi_align_bwd",) + no_k4,
               "note": no_k4, "note_full_batch": no_k4, "note_run": no_k4,
               "dock_serving": no_k1_k2_k4, "dock": no_kernel, "dock_full_batch": no_kernel,
               "dock_yaml": no_k1_k2_k4, "dock_yaml_serving": no_k1_k2_k4,
               "dock_run": no_k1_k2_k4, "dock_tta": no_k1_k2_k4,
               # phase 23: the note with masks has no FrozenBN; the dock's
               # meta model pools its ROIs with ROIPool and its support shots
               # with K1 (no gradient), and its batches carry proposals
               "note_masks_serving": ("roi_align_bwd",) + no_k4, "note_masks": no_k4,
               "dock_meta": ("roi_align_bwd", "nms_mask", "nms_mask_images"),
               # the 2-D mesh's steps of the note and of the dock with proposals
               "spatial_note_rank0": no_k4, "spatial_dock_rank0": no_kernel,
               "serving_micro": ("roi_align_bwd", "bn_act_bwd"),
               "serving_artifact_predict": ("roi_align_bwd", "bn_act_bwd"),
               "serving_artifact_b1": ("roi_align_bwd", "bn_act_bwd"),
               # a pipeline's first stage runs the backbone alone
               "pp_train_stage0": ("roi_align_fwd", "roi_align_bwd", "nms_mask",
                                   "nms_mask_images"),
               "pp_run_stage0": ("roi_align_fwd", "roi_align_bwd", "nms_mask",
                                 "nms_mask_images"),
               "serving_artifact": ("roi_align_bwd", "bn_act_bwd"),
               "dock_artifact": no_k1_k2_k4,
               "host_wire_serving_C": ("roi_align_bwd", "bn_act_bwd"),
               "host_wire_serving_PIL": ("roi_align_bwd", "bn_act_bwd"),
               "host_wire_uint8_serving": ("roi_align_bwd", "bn_act_bwd")}
    for path, counts in by_path.items():
        for name, count in counts.items():
            if name == "bn_act_layout_copies":
                continue
            if name in not_run.get(path, ()):
                if count != 0:
                    raise AssertionError(f"{name} was launched {count} times on the {path} "
                                         "path, which does not run it")
            elif count <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")

    kernels = [
        dict(name="roi_align_fwd", route="cuda", source="unit_tpu_torch/csrc/roi_align_fwd.cu",
             replaces="unit_tpu/ops/roi_align_pallas.py:230",
             launches=launches["roi_align_fwd"],
             launches_by_path=per_path("roi_align_fwd"), **k1, **k1_mask, **k1_support,
             **k1_tta, **k1_note, **k1_pairs),
        dict(name="roi_align_bwd", route="cuda", source="unit_tpu_torch/csrc/roi_align_bwd.cu",
             replaces="unit_tpu/ops/roi_align_pallas_bwd.py:564",
             launches=launches["roi_align_bwd"],
             launches_by_path=per_path("roi_align_bwd"), **k2, **k2_note, **k2_pairs),
        dict(name="nms_mask", route="cuda", source="unit_tpu_torch/csrc/nms_mask.cu",
             replaces="unit_tpu/ops/nms_pallas.py:115",
             launches=launches["nms_mask"], launches_by_path=per_path("nms_mask"), **k3,
             **k3_b2, **k3_tta, **k3_note, **k3_dock, **k3_trained),
        dict(name="bn_act", route="cuda", source="unit_tpu_torch/csrc/bn_act.cu",
             replaces="scripts/bench_backbone_epilogue.py:155",
             launches=launches["bn_act_fwd"] + launches["bn_act_bwd"],
             launches_by_path=per_path("bn_act_fwd", "bn_act_bwd"), **k4, **k4_pairs),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
