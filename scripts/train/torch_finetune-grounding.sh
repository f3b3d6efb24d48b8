#!/bin/bash
# Grounding finetune on VideoITG-40K, on the PyTorch port:
# scripts/train/finetune-grounding.sh with videoitg-train replaced by
# videoitg-torch-train, the same flags and defaults (upstream recipe:
# finetune-qwen2-7b-grounding.sh: 1024 frames @1fps, budget 16384, lr 2e-5 /
# out_proj 2e-4, cosine + 5% warmup, bf16, grad ckpt, 1 epoch).
BASE=${BASE:-/ckpts/eagle-qwen2-7b-sftv1}
DATA=${DATA:-./data/video_itg_data.json}
VIDEOS=${VIDEOS:-./data/}
OUT=${OUT:-./checkpoints-grounding}

videoitg-torch-train \
    --model ${BASE} \
    --data-path ${DATA} \
    --image-folder ${VIDEOS} \
    --video-frames 1024 --fps 1 \
    --learning-rate 2e-5 --out-proj-lr 2e-4 \
    --weight-decay 0 --warmup-ratio 0.05 --lr-scheduler-type cosine \
    --num-train-epochs 1 \
    --per-device-train-batch-size 1 \
    --save-steps 500 --save-total-limit 2 \
    --output-dir ${OUT}
