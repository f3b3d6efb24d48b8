#!/bin/bash
# Stage B: LLaVA-Video answering on ITG-32 selections, on the PyTorch port:
# scripts/eval/downstream_llava_video.sh with videoitg-eval replaced by
# videoitg-torch-eval, the same flags and defaults (upstream:
# lmms_eval/models/llava_onevision.py with frame_indices_jsonl=, the paper's
# LLaVA-Video-7B row). The llava-ov-chat adapter follows that wrapper's
# protocol variant: selected indices are DEDUPED before the ascending sort.
SELECTIONS=${SELECTIONS:-./videomme_grounding/videomme/results.jsonl}
DATA_ROOT=${DATA_ROOT:-$HF_HOME/videomme}
MODEL=${MODEL:-lmms-lab/LLaVA-Video-7B-Qwen2}
OUT=${OUT:-./videomme_answers_llava_video}

videoitg-torch-eval \
    --model llava-ov-chat \
    --model_args pretrained=${MODEL},frame_indices_jsonl=${SELECTIONS},num_frame=32 \
    --tasks ${TASKS:-videomme} \
    --data_root ${DATA_ROOT} \
    --output_path ${OUT} \
    --log_samples
