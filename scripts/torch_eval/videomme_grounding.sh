#!/bin/bash
# Stage A grounding on Video-MME, on the PyTorch port: scripts/eval/videomme_grounding.sh
# with videoitg-eval replaced by videoitg-torch-eval, the same flags and defaults
# (upstream: scripts/eval_lmms_eval/videomme_grounding.sh).
# Multi-host: launch once per host with RANK/WORLD_SIZE set; rank 0 merges. The
# port's eval/multihost.py joins the hosts over torch.distributed.
CKPT=${CKPT:-/ckpts/VideoITG-8B}
DATA_ROOT=${DATA_ROOT:-$HF_HOME/videomme}
OUT=${OUT:-./videomme_grounding}
RANK=${RANK:-0}
WORLD_SIZE=${WORLD_SIZE:-1}

videoitg-torch-eval \
    --model videoitg \
    --model_args pretrained=${CKPT},num_frames=512,target_fps=1 \
    --tasks videomme \
    --data_root ${DATA_ROOT} \
    --output_path ${OUT} \
    --rank ${RANK} --world_size ${WORLD_SIZE}
