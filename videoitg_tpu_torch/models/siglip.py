"""SigLIP vision tower (ViT-SO400M-14/384) in PyTorch.

Counterpart of videoitg_tpu/models/siglip.py: NHWC frames [T, H, W, 3] in,
patch features [T, 729, 1152] out, taken from the output of the
second-to-last encoder layer (select_layer = -2): 26 of 27 layers run and
the post-layernorm never does. The patch embedding is an unfold + matmul with
the (kh, kw, c) patch order of the JAX package. Under the act8 tier
(ops/quant.py) with the `fused` switch on, the non-attention part of each
layer runs as three fused int8 kernels (ops/fused_encoder.py). Only
arch="siglip" is ported; "clip" waits (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from videoitg_tpu_torch.config import VisionConfig
from videoitg_tpu_torch.models.common import Linear, Norm, fused_qkv, gelu_tanh, layer_norm, linear
from videoitg_tpu_torch.ops.attention import mha
from videoitg_tpu_torch.ops.fused_encoder import can_fuse_encoder_layer
from videoitg_tpu_torch.ops.quant import Act8Switches


class SiglipLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.ln1 = Norm(h, bias=True, **kw)
        self.ln2 = Norm(h, bias=True, **kw)
        self.q = Linear(h, h, generator=generator, **kw)
        self.k = Linear(h, h, generator=generator, **kw)
        self.v = Linear(h, h, generator=generator, **kw)
        self.o = Linear(h, h, generator=generator, **kw)
        self.fc1 = Linear(h, m, generator=generator, **kw)
        self.fc2 = Linear(m, h, generator=generator, **kw)


class SiglipTower(nn.Module):
    """Parameters of the tower; `siglip_features` runs it."""

    def __init__(self, cfg: VisionConfig, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.arch != "siglip":
            raise NotImplementedError(
                f"vision arch {cfg.arch!r}: only 'siglip' is ported (the clip "
                "arch is ROADMAP queue 1)")
        kw = dict(device=device, dtype=dtype)
        patch_dim = cfg.patch_size * cfg.patch_size * 3
        self.patch_embed = Linear(patch_dim, cfg.hidden_size, generator=generator, **kw)
        pos = torch.empty(cfg.num_patches, cfg.hidden_size, device=device,
                          dtype=torch.float32 if generator is not None else dtype)
        if generator is not None:
            pos = (pos.normal_(0.0, 1.0, generator=generator) * 0.02).to(dtype)
        self.pos_embed = nn.Parameter(pos, requires_grad=False)
        self.layers = nn.ModuleList(
            SiglipLayer(cfg, generator=generator, **kw) for _ in range(cfg.num_layers))


def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC [T, H, W, C] -> [T, (H//p)*(W//p), p*p*C], cropping to (H//p)*p
    like a stride-p valid conv; patch vectors in (kh, kw, c) order."""
    t, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images[:, : gh * patch, : gw * patch, :]
    x = x.reshape(t, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(t, gh * gw, patch * patch * c)


def _encoder_layer_fused(p: SiglipLayer, x: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """act8 serving path: LN + QKV, o_proj + residual and LN + MLP + residual
    each run as one fused int8 kernel, so the LN output, the int8 activation
    copies and the [*, intermediate] MLP tensor never go to device memory.
    Same dynamic-quantisation contract as ops/quant.py, with activations
    quantised from fp32 instead of a round trip through the model dtype."""
    from videoitg_tpu_torch.ops.fused_encoder import (
        fused_ln_mlp_int8,
        fused_ln_qkv_int8,
        fused_proj_residual_int8,
    )

    t, n, h = x.shape
    heads, d = cfg.num_heads, cfg.head_dim
    xf = x.reshape(t * n, h)
    q, k, v = fused_ln_qkv_int8(xf, p.ln1, p.q, p.k, p.v, cfg.layer_norm_eps)
    q, k, v = (a.reshape(t, n, heads, d).transpose(1, 2).contiguous() for a in (q, k, v))
    # As in the JAX package, the kernel attention serves wherever the fused
    # kernels do (the card); on the CPU both take their plain versions.
    attn = mha(q, k, v, valid=None, causal=False, use_flash=x.device.type == "cuda")
    attn = attn.transpose(1, 2).reshape(t * n, heads * d)
    x1 = fused_proj_residual_int8(attn, xf, p.o)
    act = "quick_gelu" if cfg.arch == "clip" else "gelu_tanh"
    out = fused_ln_mlp_int8(x1, p.ln2, p.fc1, p.fc2, cfg.layer_norm_eps, act=act)
    return out.reshape(t, n, h)


def _encoder_layer(p: SiglipLayer, x: torch.Tensor, cfg: VisionConfig,
                   use_flash: bool, act8: Act8Switches) -> torch.Tensor:
    # The gate of the JAX package: the kernel attention asked for, the switch
    # on, every linear int8 + act_q, and a q projection that is not padded.
    if (use_flash and act8.fused and can_fuse_encoder_layer(p)
            and p.q.out_features == x.shape[-1]):
        return _encoder_layer_fused(p, x, cfg)
    t, n, h = x.shape
    heads, d = cfg.num_heads, cfg.head_dim
    y = layer_norm(p.ln1, x, cfg.layer_norm_eps)
    q, k, v = fused_qkv(p.q, p.k, p.v, y, act8)
    # [T, P, H*D] -> [T, H, P, D], contiguous for the kernel.
    q, k, v = (a.reshape(t, n, heads, d).transpose(1, 2).contiguous() for a in (q, k, v))
    attn = mha(q, k, v, valid=None, causal=False, use_flash=use_flash,
               sm_scale=cfg.head_dim ** -0.5)
    attn = attn.transpose(1, 2).reshape(t, n, heads * d)
    x = x + linear(p.o, attn, act8)
    y = layer_norm(p.ln2, x, cfg.layer_norm_eps)
    return x + linear(p.fc2, gelu_tanh(linear(p.fc1, y, act8)), act8)


def siglip_features(tower: SiglipTower, images: torch.Tensor, cfg: VisionConfig,
                    use_flash: bool = False,
                    act8: Act8Switches = Act8Switches()) -> torch.Tensor:
    """[T, H, W, 3] preprocessed frames -> [T, tokens, hidden] features from
    cfg.num_effective_layers encoder layers, no post-layernorm. `act8` says
    which act8 products run in the hand-written int8 kernels."""
    x = linear(tower.patch_embed, _patchify(images, cfg.patch_size))
    x = x + tower.pos_embed.to(x.dtype)[None]
    for layer in tower.layers[: cfg.num_effective_layers]:
        x = _encoder_layer(layer, x, cfg, use_flash, act8)
    return x


def init_siglip(cfg: VisionConfig, generator: torch.Generator, *, device=None,
                dtype=torch.float32) -> SiglipTower:
    """Random tower with the JAX package's distributions (not its bits)."""
    return SiglipTower(cfg, device=device, dtype=dtype, generator=generator)
