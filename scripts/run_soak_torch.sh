#!/bin/bash
# Recipe-length soak of the PyTorch/CUDA port (twin of scripts/run_soak.sh):
# the VOC schedule's shape -- LR steps, periodic evaluation and best-AP50
# rotation (max_to_keep 3) -- on shapes-VOC at a reduced canvas, with one
# SIGTERM mid-run and a --resume, then scripts/verify_soak_torch.py checks
# that the resumed loss curve is continuous, the LR dropped at each step,
# the checkpoints rotated and the best-AP bookkeeping survived.  The same
# stages, log names and settings as run_soak.sh, through
# scripts/train_VOC_torch.py (on the card unless CLI_ARGS says otherwise).
#
#   [ITERS=30000] [KILL_AT=15000] [STEPS="(12000,24000)"] \
#   [CHECKPOINT_PERIOD=2000] [EVAL_PERIOD=2000] [POLL=30] [CLI_ARGS="--device cpu"] \
#     bash scripts/run_soak_torch.sh <shapes-VOC devkit root> <runs dir>
#
# A shorter run keeps the schedule's shape by scaling STEPS and the periods
# with ITERS, e.g. ITERS=4000 KILL_AT=2000 STEPS="(1600,3200)"
# CHECKPOINT_PERIOD=500 EVAL_PERIOD=500.  The devkit comes from
# scripts/make_shapes_voc_torch.py.
set -e
cd "$(dirname "$0")/.."
ROOT=${1:-/root/data/shapes_voc}
RUNS=${2:-/root/runs_soak}
ITERS=${ITERS:-30000}
KILL_AT=${KILL_AT:-15000}
STEPS=${STEPS:-(12000,24000)}
CHECKPOINT_PERIOD=${CHECKPOINT_PERIOD:-2000}
EVAL_PERIOD=${EVAL_PERIOD:-2000}
mkdir -p "$RUNS"

# From-scratch settings (no MSRA pickle in the image): FREEZE_AT 0 and a
# gentler LR than the recipe's 0.02-at-batch-8 -- the schedule SHAPE (steps,
# warmup, eval/ckpt cadence) is the thing under test.
OPTS="OUTPUT_DIR $RUNS/soak \
  SOLVER.MAX_ITER $ITERS SOLVER.IMS_PER_BATCH 4 \
  SOLVER.BASE_LR 0.004 SOLVER.WARMUP_ITERS 1000 \
  SOLVER.STEPS $STEPS \
  SOLVER.CHECKPOINT_PERIOD $CHECKPOINT_PERIOD TEST.EVAL_PERIOD $EVAL_PERIOD \
  MODEL.BACKBONE.FREEZE_AT 0 \
  INPUT.MIN_SIZE_TRAIN (320,) INPUT.MAX_SIZE_TRAIN 320 \
  INPUT.MIN_SIZE_TEST 320 INPUT.MAX_SIZE_TEST 320"

last_iter() {
  tail -1 "$RUNS/soak/metrics.json" 2>/dev/null | python -c \
    "import sys,json;print(json.load(sys.stdin).get('iteration',0))" 2>/dev/null || echo 0
}

echo "=== soak stage 1: train to ~$KILL_AT then SIGTERM ==="
python scripts/train_VOC_torch.py \
  --config-file configs/VOC/VOC-RCNN-101-C4-split1.yaml \
  --data-root "$ROOT" ${CLI_ARGS:-} MODEL.WEIGHTS "" $OPTS > "$RUNS/stage1.log" 2>&1 &
PID=$!
echo $PID > "$RUNS/train.pid"

# wait until metrics.json crosses KILL_AT, then preempt
while kill -0 $PID 2>/dev/null; do
  sleep "${POLL:-30}"
  LAST=$(last_iter)
  echo "  iter $LAST"
  if [ "${LAST:-0}" -ge "$KILL_AT" ]; then
    echo "=== SIGTERM at iter $LAST ==="
    kill -TERM $PID
    break
  fi
done
wait $PID || true
if [ "$(last_iter)" -ge "$ITERS" ]; then
  echo "!!! run finished before SIGTERM fired — soak still valid but no preempt"
fi

echo "=== soak stage 2: --resume to $ITERS ==="
python scripts/train_VOC_torch.py \
  --config-file configs/VOC/VOC-RCNN-101-C4-split1.yaml \
  --data-root "$ROOT" --resume ${CLI_ARGS:-} MODEL.WEIGHTS "" $OPTS > "$RUNS/stage2.log" 2>&1

echo "=== soak verify ==="
python scripts/verify_soak_torch.py "$RUNS/soak" --iters "$ITERS" \
  --steps $(echo "$STEPS" | tr -d '()' | tr ',' ' ')
