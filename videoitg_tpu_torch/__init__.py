"""videoitg_tpu_torch — the PyTorch/CUDA port of videoitg_tpu for NVIDIA Hopper.

The JAX package `videoitg_tpu` stays the reference. This package mirrors its
module names (models/siglip.py <-> models/siglip.py, and so on), imports its
jax-free modules (config, data, tokenizer, resize matrices) instead of
copying them, and never imports jax. The attention kernels on the grounding
selection path are hand-written CUDA C++ for sm_90a (csrc/), built on first
use.
"""

__version__ = "0.1.0"
