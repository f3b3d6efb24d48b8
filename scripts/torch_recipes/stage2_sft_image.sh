#!/bin/bash
# Stage 2/4 — OV image SFT (ChatML), full finetune at lr 2e-5, on the PyTorch
# port: scripts/recipes/stage2_sft_image.sh with videoitg-train replaced by
# videoitg-torch-train, the same flags and defaults (upstream recipe:
# scripts/videoitg/finetune-qwen2-7b-ov.sh).
set -euo pipefail
BASE=${BASE:-./checkpoints/stage1-pretrain}
DATA=${DATA:-./data/ov_image_sft.json}
IMAGES=${IMAGES:-./data/images}
OUT=${OUT:-./checkpoints/stage2-ov-sft}

videoitg-torch-train \
    --model "$BASE" \
    --objective vlm --conv-template chatml \
    --data-path "$DATA" --image-folder "$IMAGES" \
    --learning-rate 2e-5 \
    --video-frames 64 --fps 1 \
    --num-train-epochs 1 \
    --per-device-train-batch-size 1 \
    --gradient-accumulation-steps 1 \
    --weight-decay 0 --warmup-ratio 0.03 --lr-scheduler-type cosine \
    --save-steps 500 --save-total-limit 1 --logging-steps 1 \
    --output-dir "$OUT" "$@"
