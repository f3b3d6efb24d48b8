#!/usr/bin/env bash
# Training that learns, on the PyTorch port: the 2B tier learns a synthetic
# 32-video grounding set to Top-1 >= 0.9 with one mid-run SIGKILL + resume.
# On the card: bash scripts/train/torch_overfit_smoke.sh --lora 16 --steps 400 --batch 2 --lr 2e-4
# On the CPU add --cpu (and --preset tiny for a size the CPU takes).
set -e
cd "$(dirname "$0")/../.."
exec python scripts/train/torch_overfit_smoke.py "$@"
