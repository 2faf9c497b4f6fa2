#!/bin/bash
# The shapes-VOC accuracy pipeline of the PyTorch/CUDA port (twin of
# scripts/run_shapes_pipeline.sh):
#   base training (a cut schedule) -> --eval-only from the best checkpoint ->
#   10-shot fine-tune warm-started from it, with its final evaluation.
# Runs the user CLIs (train_VOC_torch.py / finetune_VOC_torch.py) on the
# shipped split-1 recipes with dotted overrides, on a devkit from
# scripts/make_shapes_voc_torch.py.  Run from anywhere; each stage logs to
# <runs>/<stage>.log and the last lines are the "csv:" results.
#
# Usage: [ITERS=600] [EXTRA_OPTS="..."] [CLI_ARGS="--device cpu"] \
#          scripts/run_shapes_pipeline_torch.sh <devkit root> <runs dir>
#
# EXTRA_OPTS: more dotted config overrides for every stage, e.g.
#   EXTRA_OPTS="MODEL.BACKBONE.FREEZE_AT 0" for a run from random weights (no
#   ImageNet weights: a frozen random stem cripples learning).
# CLI_ARGS: more CLI flags for every stage; the CLIs run on the card unless
#   given "--device cpu".
set -eo pipefail
cd "$(dirname "$0")/.."
ROOT=${1:?usage: run_shapes_pipeline_torch.sh <devkit root> <runs dir>}
RUNS=${2:?usage: run_shapes_pipeline_torch.sh <devkit root> <runs dir>}
ITERS=${ITERS:-600}
mkdir -p "$RUNS"

COMMON_INPUT="INPUT.MIN_SIZE_TRAIN (320,) INPUT.MAX_SIZE_TRAIN 320 INPUT.MIN_SIZE_TEST 320 INPUT.MAX_SIZE_TEST 320 ${EXTRA_OPTS:-}"

echo "=== [1/3] base training ($ITERS iters) ==="
python scripts/train_VOC_torch.py \
  --config-file configs/VOC/VOC-RCNN-101-C4-split1.yaml \
  --data-root "$ROOT" ${CLI_ARGS:-} \
  OUTPUT_DIR "$RUNS/shapes_base" \
  MODEL.WEIGHTS "" \
  SOLVER.MAX_ITER $ITERS SOLVER.IMS_PER_BATCH 4 SOLVER.BASE_LR 0.01 \
  SOLVER.STEPS "($((ITERS*2/3)),)" SOLVER.WARMUP_ITERS 100 \
  SOLVER.CHECKPOINT_PERIOD 200 TEST.EVAL_PERIOD 300 \
  $COMMON_INPUT \
  2>&1 | tee "$RUNS/shapes_base.log"

echo "=== [2/3] eval-only from best checkpoint ==="
python scripts/train_VOC_torch.py \
  --config-file configs/VOC/VOC-RCNN-101-C4-split1.yaml \
  --data-root "$ROOT" --eval-only ${CLI_ARGS:-} \
  OUTPUT_DIR "$RUNS/shapes_base_eval" \
  MODEL.WEIGHTS "$RUNS/shapes_base/best/model" \
  $COMMON_INPUT \
  2>&1 | tee "$RUNS/shapes_base_eval.log"

echo "=== [3/3] 10-shot fine-tune ==="
python scripts/finetune_VOC_torch.py \
  --config-file configs/VOC/FT/10_shot/VOC-RCNN-101-C4-split1-ft.yaml \
  --data-root "$ROOT" ${CLI_ARGS:-} \
  OUTPUT_DIR "$RUNS/shapes_ft10" \
  MODEL.WEIGHTS "$RUNS/shapes_base/best/model" \
  SOLVER.MAX_ITER 300 SOLVER.IMS_PER_BATCH 4 TEST.EVAL_PERIOD 300 \
  SOLVER.CHECKPOINT_PERIOD 150 \
  $COMMON_INPUT \
  2>&1 | tee "$RUNS/shapes_ft10.log"

echo "=== pipeline done ==="
grep -h "csv:" "$RUNS"/shapes_base.log "$RUNS"/shapes_base_eval.log "$RUNS"/shapes_ft10.log | tail -40
