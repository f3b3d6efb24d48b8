"""PIL-faithful uint8 resize as two fp32 matmuls.

Counterpart of `pil_resize_uint8` in videoitg_tpu/ops/resize.py, built on
that module's shared numpy matrix `pil_resample_matrix` (PIL's antialiased
resampling coefficients). PIL runs the horizontal pass first, rounds half up
and clips the intermediate to [0, 255], then runs the vertical pass and
rounds/clips again; matching that clipping matters on high-frequency content.
"""

from __future__ import annotations

import torch

from videoitg_tpu.ops.resize import pil_resample_matrix


def _round_clip8(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5).clamp_(0.0, 255.0)


def pil_resize_uint8(images: torch.Tensor, out_h: int, out_w: int,
                     filter: str = "bicubic") -> torch.Tensor:
    """[..., H, W] values in [0, 255] -> [..., out_h, out_w] fp32 integral values."""
    h, w = images.shape[-2], images.shape[-1]
    mh = torch.from_numpy(pil_resample_matrix(h, out_h, filter)).to(images.device)
    mw = torch.from_numpy(pil_resample_matrix(w, out_w, filter)).to(images.device)
    x = images.float()
    x = _round_clip8(torch.einsum("ow,...hw->...ho", mw, x))  # horizontal pass
    return _round_clip8(torch.einsum("oh,...hw->...ow", mh, x))  # vertical pass
