#!/bin/bash
# Stage B: Qwen3-VL answering on ITG-32 selections, on the PyTorch port:
# scripts/eval/downstream_qwen3vl.sh with videoitg-eval replaced by
# videoitg-torch-eval, the same flags and defaults (upstream: qwen3_vl.sh,
# accelerate launch -m lmms_eval --model qwen3_vl). Multi-host: one process per
# host, RANK/WORLD_SIZE shard docs; the port's eval/multihost.py joins the hosts
# over torch.distributed.
SELECTIONS=${SELECTIONS:-./videomme_grounding/videomme/results.jsonl}
DATA_ROOT=${DATA_ROOT:-$HF_HOME/videomme}
MODEL=${MODEL:-Qwen/Qwen3-VL-8B-Instruct}
OUT=${OUT:-./videomme_answers_qwen3vl}

videoitg-torch-eval \
    --model qwen-vl-chat \
    --model_args pretrained=${MODEL},frame_indices_jsonl=${SELECTIONS},num_frame=32 \
    --tasks ${TASKS:-videomme} \
    --data_root ${DATA_ROOT} \
    --output_path ${OUT} \
    --log_samples
