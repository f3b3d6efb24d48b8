#!/bin/bash
# Stage B: Eagle2.5-8B answering on ITG-32 selections, on the PyTorch port:
# scripts/eval/downstream_eagle2_5.sh with videoitg-eval replaced by
# videoitg-torch-eval, the same flags and defaults (upstream: eagle2_5.sh, which
# runs videomme/mlvu/longvideobench/cgbench in sequence; Eagle2.5 speaks the
# InternVL chat protocol, so the internvl-chat adapter drives it).
SELECTIONS_DIR=${SELECTIONS_DIR:-./grounding_out}
DATA_ROOT=${DATA_ROOT:-$HF_HOME}
MODEL=${MODEL:-nvidia/Eagle2.5-8B}
OUT=${OUT:-./eagle25_answers}

for TASK in ${TASKS:-videomme mlvu longvideobench_val_v cgbench_subtitles}; do
  videoitg-torch-eval \
      --model internvl-chat \
      --model_args pretrained=${MODEL},frame_indices_jsonl=${SELECTIONS_DIR}/${TASK}/results.jsonl,num_frame=32 \
      --tasks ${TASK} \
      --data_root ${DATA_ROOT}/${TASK} \
      --output_path ${OUT}/${TASK} \
      --log_samples
done
