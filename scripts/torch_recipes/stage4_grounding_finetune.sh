#!/bin/bash
# Stage 4/4 — THE VideoITG grounding finetune (plain template, BCE loss,
# out_proj at 10x LR), on the PyTorch port:
# scripts/recipes/stage4_grounding_finetune.sh with videoitg-train replaced by
# videoitg-torch-train, the same flags and defaults (upstream recipe:
# scripts/videoitg/finetune-qwen2-7b-grounding.sh: 1024 frames @ 1 fps,
# vision_token_num 16384 from the checkpoint's videoitg_tpu_config.json, lr 2e-5
# + out_proj 2e-4, cosine, warmup 0.05, 1 epoch; 128x A100-80G, ~4 h).
# Difference: the mesh. DP x TP > 1 runs one process per GPU under
# `torchrun --nproc-per-node DP*TP -m videoitg_tpu_torch.cli.train --dp DP --tp TP`:
# the port's mesh axes above 1 need a torchrun group (without one the CLI
# exits 2). Scale --gradient-accumulation-steps with the mesh.
set -euo pipefail
BASE=${BASE:-./checkpoints/stage3-video-sft}
DATA=${DATA:-./data/video_itg_data.json}   # {"video","question","clip_num"}
VIDEOS=${VIDEOS:-./data}
OUT=${OUT:-./checkpoints/stage4-grounding}
DP=${DP:-1}
TP=${TP:-1}

if [ $((DP * TP)) -gt 1 ]; then
    TRAIN=(torchrun --nproc-per-node $((DP * TP)) -m videoitg_tpu_torch.cli.train --dp "$DP" --tp "$TP")
else
    TRAIN=(videoitg-torch-train)
fi

"${TRAIN[@]}" \
    --model "$BASE" \
    --objective grounding \
    --data-path "$DATA" --image-folder "$VIDEOS" \
    --video-frames 1024 --fps 1 \
    --learning-rate 2e-5 --out-proj-lr 2e-4 \
    --num-train-epochs 1 \
    --per-device-train-batch-size 1 \
    --gradient-accumulation-steps 1 \
    --weight-decay 0 --warmup-ratio 0.05 --lr-scheduler-type cosine \
    --save-steps 500 --save-total-limit 2 --logging-steps 1 \
    --output-dir "$OUT" "$@"
