"""videoitg_tpu_torch — the PyTorch/CUDA port of videoitg_tpu for NVIDIA Hopper.

The JAX package `videoitg_tpu` stays the reference. This package mirrors its
module names (models/siglip.py <-> models/siglip.py, and so on), keeps its
own copy of the framework-free modules it needs (config, constants, data,
tokenizer, resize matrices) and imports neither jax nor anything of
`videoitg_tpu`. The kernels on the grounding selection path (attention, and
the int8 products of the act8 serving tier), on the training paths of the
grounding model and the causal VLM (differentiable attention: forward, dQ,
dK/dV, with a key mask or with segment ids) are hand-written CUDA C++ for
sm_90a (csrc/), built on first use.
"""

__version__ = "0.1.0"
