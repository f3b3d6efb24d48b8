"""Model adapter registry — importing registers all adapters.

The port has the grounding adapter; the downstream and VLM adapters of the
JAX package are ROADMAP queue 1, items 5b and 5c (eval.api.NOT_PORTED_ADAPTERS).
"""

from videoitg_tpu_torch.eval.adapters import videoitg  # noqa: F401
