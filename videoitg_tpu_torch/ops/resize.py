"""PIL-faithful uint8 resize as two fp32 matmuls, and the resize matrices.

Counterpart of videoitg_tpu/ops/resize.py. The numpy matrix builders
(`bilinear_resize_matrix`: torch bilinear align_corners=False;
`pil_resample_matrix`: PIL's antialiased resampling coefficients) are the
port's own copy, held bit for bit to the originals by the tests.
`pil_resize_uint8` applies them the way PIL does: the horizontal pass first,
rounded half up and clipped to [0, 255], then the vertical pass, rounded and
clipped again; matching that clipping matters on high-frequency content.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def bilinear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] weights matching torch bilinear align_corners=False.

    Semantics (torch area_pixel_compute_source_index): the source coordinate
    of output pixel o is max(0, (o + 0.5) * (in/out) - 0.5); two taps at
    floor(src) and min(floor(src)+1, in-1) with weights (1-frac, frac).
    No antialiasing (matches F.interpolate default used by the reference
    projector at mlp_proj.py:61-67).
    """
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        if src < 0.0:
            src = 0.0
        i0 = int(math.floor(src))
        if i0 > in_size - 1:
            i0 = in_size - 1
        i1 = min(i0 + 1, in_size - 1)
        frac = src - i0
        w[o, i0] += 1.0 - frac
        w[o, i1] += frac
    return w.astype(np.float32)


def _bicubic_kernel(x: float, a: float = -0.5) -> float:
    """PIL's bicubic filter (Catmull-Rom family, a=-0.5)."""
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def _bilinear_kernel(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_PIL_FILTERS = {
    "bicubic": (_bicubic_kernel, 2.0),
    "bilinear": (_bilinear_kernel, 1.0),
}


@lru_cache(maxsize=None)
def pil_resample_matrix(in_size: int, out_size: int, filter: str = "bicubic") -> np.ndarray:
    """[out_size, in_size] weights matching PIL Image.resize with antialias.

    Implements PIL's precompute_coeffs (libImaging/Resample.c): when
    downscaling, the kernel is stretched by the scale factor (antialiasing);
    weights within the clipped window are renormalized to sum to 1. PIL's
    uint8 path then quantizes coefficients to fixed point; we keep float32,
    which agrees to ~1e-2 of a 1/255 level. HF SiglipImageProcessor resizes
    with exactly this filter (resample=BICUBIC) before rescale+normalize.
    """
    kernel, support0 = _PIL_FILTERS[filter]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ss = 1.0 / filterscale
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        weights = [kernel((x - center + 0.5) * ss) for x in range(xmin, xmax)]
        total = sum(weights)
        if total != 0.0:
            weights = [v / total for v in weights]
        w[o, xmin:xmax] = weights
    return w.astype(np.float32)


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
