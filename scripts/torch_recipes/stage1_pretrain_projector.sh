#!/bin/bash
# Stage 1/4 — projector pretrain on caption pairs (BLIP-LAION-558k style), on
# the PyTorch port: scripts/recipes/stage1_pretrain_projector.sh with
# videoitg-train replaced by videoitg-torch-train, the same flags and defaults
# (upstream recipe: scripts/videoitg/pretrain-qwen2-7b.sh; plain template,
# adapter-only training, lr 1e-3, cosine, warmup 0.03).
# Difference: the mesh. DP x TP > 1 runs one process per GPU under
# `torchrun --nproc-per-node DP*TP -m videoitg_tpu_torch.cli.train --dp DP --tp TP`:
# the port's mesh axes above 1 need a torchrun group (without one the CLI
# exits 2). DeepSpeed ZeRO-1 -> dp / tp ranks; grad ckpt always on (remat).
set -euo pipefail
BASE=${BASE:-/ckpts/qwen2-7b-with-siglip}   # HF-format starting point
DATA=${DATA:-./data/blip_laion_cc_sbu_558k.json}
IMAGES=${IMAGES:-./data/llava_pretrain_images}
OUT=${OUT:-./checkpoints/stage1-pretrain}
DP=${DP:-1}
TP=${TP:-1}

if [ $((DP * TP)) -gt 1 ]; then
    TRAIN=(torchrun --nproc-per-node $((DP * TP)) -m videoitg_tpu_torch.cli.train --dp "$DP" --tp "$TP")
else
    TRAIN=(videoitg-torch-train)
fi

"${TRAIN[@]}" \
    --model "$BASE" \
    --objective vlm --conv-template plain \
    --data-path "$DATA" --image-folder "$IMAGES" \
    --tune-projector-only --mm-projector-lr 1e-3 \
    --learning-rate 1e-3 \
    --video-frames 64 --fps 1 \
    --num-train-epochs 1 \
    --per-device-train-batch-size 2 \
    --gradient-accumulation-steps 1 \
    --weight-decay 0 --warmup-ratio 0.03 --lr-scheduler-type cosine \
    --save-steps 500 --save-total-limit 1 --logging-steps 1 \
    --output-dir "$OUT" "$@"
