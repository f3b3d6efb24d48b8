#!/bin/bash
# Stage 3/4 — video SFT at 256 frames (ChatML), lr 2e-5, on the PyTorch port:
# scripts/recipes/stage3_sft_video.sh with videoitg-train replaced by
# videoitg-torch-train, the same flags and defaults (upstream recipe:
# scripts/videoitg/finetune-qwen2-7b-video.sh).
# (--fps -1 would enable the random-fps augmentation of train_vlm.py.)
set -euo pipefail
BASE=${BASE:-./checkpoints/stage2-ov-sft}
DATA=${DATA:-./data/video_sft.json}
VIDEOS=${VIDEOS:-./data/videos}
OUT=${OUT:-./checkpoints/stage3-video-sft}

videoitg-torch-train \
    --model "$BASE" \
    --objective vlm --conv-template chatml \
    --data-path "$DATA" --image-folder "$VIDEOS" \
    --learning-rate 2e-5 \
    --video-frames 256 --fps 1 \
    --num-train-epochs 1 \
    --per-device-train-batch-size 1 \
    --gradient-accumulation-steps 1 \
    --weight-decay 0 --warmup-ratio 0.03 --lr-scheduler-type cosine \
    --save-steps 500 --save-total-limit 2 --logging-steps 1 \
    --output-dir "$OUT" "$@"
