#!/bin/bash
# Stage B: InternVL2.5 answering on ITG-32 selections, on the PyTorch port:
# scripts/eval/downstream_internvl.sh with videoitg-eval replaced by
# videoitg-torch-eval, the same flags and defaults (upstream: internvl2.5.sh).
SELECTIONS=${SELECTIONS:-./videomme_grounding/videomme/results.jsonl}
DATA_ROOT=${DATA_ROOT:-$HF_HOME/videomme}
MODEL=${MODEL:-OpenGVLab/InternVL2_5-8B}
OUT=${OUT:-./videomme_answers}

videoitg-torch-eval \
    --model hf-video-llm \
    --model_args pretrained=${MODEL},frame_indices_jsonl=${SELECTIONS},num_frame=32 \
    --tasks videomme \
    --data_root ${DATA_ROOT} \
    --output_path ${OUT}
