"""The projector families: tower features -> LM-space tokens.

Counterpart of videoitg_tpu/models/projector.py (the reference's projector factory
families). seq_mlp, VideoITG's own: [T, P, C] tower features are viewed as
T grids of sqrt(P)^2, resized to hw x hw exactly like torch
`F.interpolate(mode="bilinear", align_corners=False)` through the numpy
matrix `bilinear_resize_matrix` (ops/resize.py), in fp32, then Linear /
GELU(erf) / Linear. The per-token families keep one token per patch:
"linear" (one Linear), "mlpNx_gelu" (N Linears with GELU(erf) between) and
"identity" (no parameters). Every preset uses seq_mlp; the other families
come from a checkpoint's videoitg_tpu_config.json. On a tensor-parallel mesh
fc1 is column-parallel and fc2 row-parallel (parallel/sharding.py): `linear`
runs each rank's slice and its collective.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch
from torch import nn

from videoitg_tpu_torch.config import ProjectorConfig
from videoitg_tpu_torch.models.common import Linear, gelu_exact, linear
from videoitg_tpu_torch.ops.resize import bilinear_resize_matrix


class Projector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        t = cfg.projector_type
        if t == "identity":
            return
        self.fc1 = Linear(cfg.input_dim, cfg.output_dim, **kw)
        for i in range(2, _depth(t) + 1):
            setattr(self, f"fc{i}", Linear(cfg.output_dim, cfg.output_dim, **kw))


def _depth(projector_type: str) -> int:
    """Linears of a family with parameters: linear 1, seq_mlp 2, mlpNx_gelu N."""
    if projector_type in ("linear", "seq_mlp"):
        return 1 if projector_type == "linear" else 2
    m = re.fullmatch(r"mlp(\d+)x_gelu", projector_type)
    if not m:
        raise ValueError(f"unknown projector type {projector_type!r}")
    return int(m.group(1))


def pool_frame_grid(feats: torch.Tensor, hw: int) -> torch.Tensor:
    """[..., P, C] -> [..., hw*hw, C] bilinear pool over the sqrt(P) grid, in fp32."""
    *lead, p, c = feats.shape
    ori = math.isqrt(p)
    if ori * ori != p:
        raise ValueError(f"patch count {p} is not square")
    if hw >= ori:
        return feats
    m = torch.from_numpy(bilinear_resize_matrix(ori, hw)).to(feats.device)  # [hw, ori]
    x = feats.reshape(*lead, ori, ori, c).float()
    x = torch.einsum("oh,...hwc->...owc", m, x)
    x = torch.einsum("ow,...hwc->...hoc", m, x)
    return x.reshape(*lead, hw * hw, c).to(feats.dtype)


def project_frames(p: Projector, feats: torch.Tensor, hw: int) -> torch.Tensor:
    """[T, P, C] tower features -> [T, hw*hw, D] LM-space tokens."""
    return linear(p.fc2, gelu_exact(linear(p.fc1, pool_frame_grid(feats, hw))))


def apply_projector(p: Projector, feats: torch.Tensor, cfg: ProjectorConfig,
                    hw: Optional[int] = None) -> torch.Tensor:
    """The family's map: seq_mlp pools to the per-video hw (required); the
    per-token families ignore hw."""
    t = cfg.projector_type
    if t == "seq_mlp":
        if hw is None:
            raise ValueError("seq_mlp needs the per-video hw")
        return project_frames(p, feats, hw)
    if t == "identity":
        return feats
    x = linear(p.fc1, feats)
    for i in range(2, _depth(t) + 1):
        x = linear(getattr(p, f"fc{i}"), gelu_exact(x))
    return x


def frame_token_count(cfg: ProjectorConfig, hw: int, num_patches: int) -> int:
    """LM tokens per frame: seq_mlp pools to hw^2; the other families keep
    one token per patch."""
    return hw * hw if cfg.projector_type == "seq_mlp" else num_patches


def inference_hw(cfg: ProjectorConfig, num_frames: int, ori_hw: int = 27) -> int:
    """Per-video hw at inference: floor(sqrt(budget / T)) clamped to the grid."""
    return cfg.tokens_hw(num_frames, ori_hw)


def training_hw(cfg: ProjectorConfig, num_frames: int, ori_hw: int, rng) -> int:
    """Random per-batch hw for training: uniform on [vision_min_num,
    floor(sqrt(budget / T))] (both ends included), clamped to the grid. `rng`
    is a `random.Random`; the draw happens on the host."""
    hw_max = math.floor(math.sqrt(cfg.vision_token_num / num_frames))
    hw = rng.randint(cfg.vision_min_num, hw_max)
    return min(hw, ori_hw)


def init_projector(cfg: ProjectorConfig, generator: torch.Generator, *, device=None,
                   dtype=torch.float32) -> Projector:
    return Projector(cfg, device=device, dtype=dtype, generator=generator)
