"""Model adapter registry — importing registers all adapters."""

from videoitg_tpu_torch.eval.adapters import (  # noqa: F401
    api_chat, downstream, native_vlm, videoitg,
)
