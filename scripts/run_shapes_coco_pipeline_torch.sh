#!/bin/bash
# The shapes-COCO accuracy pipeline of the PyTorch/CUDA port (twin of
# scripts/run_shapes_coco_pipeline.sh): instance-segmentation base training
# -> --eval-only from the best checkpoint -> 10-shot segm fine-tune with its
# final evaluation.  Runs the shipped COCO segm recipes (the mask head, the
# similarity mask transfer, the COCO evaluator with its novel slice) through
# the user CLI train_net_torch.py, on a root from
# scripts/make_shapes_coco_torch.py.  Each stage logs to <runs>/<stage>.log.
#
# Usage: [ITERS=4000] [EXTRA_OPTS="..."] [CLI_ARGS="--device cpu"] \
#          scripts/run_shapes_coco_pipeline_torch.sh <COCO-layout root> <runs dir>
#
# CLI_ARGS: more CLI flags for every stage; the CLI runs on the card unless
# given "--device cpu".
set -eo pipefail
cd "$(dirname "$0")/.."
ROOT=${1:?usage: run_shapes_coco_pipeline_torch.sh <COCO-layout root> <runs dir>}
RUNS=${2:?usage: run_shapes_coco_pipeline_torch.sh <COCO-layout root> <runs dir>}
ITERS=${ITERS:-4000}
mkdir -p "$RUNS"

COMMON="INPUT.MIN_SIZE_TRAIN (320,) INPUT.MAX_SIZE_TRAIN 320 INPUT.MIN_SIZE_TEST 320 INPUT.MAX_SIZE_TEST 320 ${EXTRA_OPTS:-}"

echo "=== [1/3] COCO segm base training ($ITERS iters) ==="
python scripts/train_net_torch.py \
  --config-file configs/COCO/COCO-RCNN-50-C4-split1-segm.yaml \
  --data-root "$ROOT" ${CLI_ARGS:-} \
  OUTPUT_DIR "$RUNS/base" \
  MODEL.WEIGHTS "" \
  SOLVER.MAX_ITER $ITERS SOLVER.IMS_PER_BATCH 4 \
  SOLVER.STEPS "($((ITERS*2/3)),)" \
  SOLVER.CHECKPOINT_PERIOD 500 TEST.EVAL_PERIOD 500 \
  $COMMON \
  2>&1 | tee "$RUNS/base.log"

echo "=== [2/3] eval-only from best checkpoint ==="
python scripts/train_net_torch.py \
  --config-file configs/COCO/COCO-RCNN-50-C4-split1-segm.yaml \
  --data-root "$ROOT" --eval-only ${CLI_ARGS:-} \
  OUTPUT_DIR "$RUNS/base_eval" \
  MODEL.WEIGHTS "$RUNS/base/best/model" \
  $COMMON \
  2>&1 | tee "$RUNS/base_eval.log"

echo "=== [3/3] 10-shot segm fine-tune ==="
python scripts/train_net_torch.py \
  --config-file configs/COCO/COCO-RCNN-50-C4-split1-segm-ft.yaml \
  --data-root "$ROOT" ${CLI_ARGS:-} \
  OUTPUT_DIR "$RUNS/ft10" \
  MODEL.WEIGHTS "$RUNS/base/best/model" \
  SOLVER.MAX_ITER 300 SOLVER.IMS_PER_BATCH 4 TEST.EVAL_PERIOD 300 \
  SOLVER.CHECKPOINT_PERIOD 150 \
  $COMMON \
  2>&1 | tee "$RUNS/ft10.log"

echo "=== pipeline done ==="
grep -h "csv:" "$RUNS"/base.log "$RUNS"/base_eval.log "$RUNS"/ft10.log | tail -60
