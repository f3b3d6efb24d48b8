"""SigLIP vision tower (ViT-SO400M-14/384) in PyTorch, and its CLIP variant.

Counterpart of videoitg_tpu/models/siglip.py: NHWC frames [T, H, W, 3] in,
patch features [T, 729, 1152] out, taken from the output of the
second-to-last encoder layer (select_layer = -2): 26 of 27 layers run and
the post-layernorm never does. The patch embedding is an unfold + matmul with
the (kh, kw, c) patch order of the JAX package. Under the act8 tier
(ops/quant.py) with the `fused` switch on, the non-attention part of each
layer runs as three fused int8 kernels (ops/fused_encoder.py), never under a
device mesh. On a tensor-parallel mesh each rank runs its 16/tp heads and its
slice of the MLP (parallel/tensor.py). `remat=True` recomputes each layer in
the backward pass. With the inference kernels asked for (`use_flash=True`)
and no gradient (the engine's inference mode) each residual add runs in one
kernel with the LayerNorm after it (ops/layer_norm.add_layer_norm);
`use_flash=False` stays the plain tower. `pad_attention_heads` widens the
heads to a lane width in the weights; the layer reads the per-head width from
them.

arch="clip" is HF CLIP's tower (e.g. LLaVA-1.5's ViT-L/14-336): a biasless
patch embedding, a CLS token prepended before the positions (a table of
num_patches + 1 rows), a pre-layernorm, quick_gelu in the MLP, and the CLS
position dropped from the output when select_feature == "patch".
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from videoitg_tpu_torch.config import VisionConfig
from videoitg_tpu_torch.models.common import (Linear, Norm, fused_qkv, gelu_tanh, layer_norm,
                                              linear, linear_held_bias, linear_span, quick_gelu)
from videoitg_tpu_torch.ops.attention import mha
from videoitg_tpu_torch.ops.fused_encoder import can_fuse_encoder_layer
from videoitg_tpu_torch.ops.layer_norm import add_layer_norm, residual_add
from videoitg_tpu_torch.ops.quant import Act8Switches
from videoitg_tpu_torch.utils import profiling


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
        if cfg.arch not in ("siglip", "clip"):
            raise ValueError(f"unknown vision arch {cfg.arch!r}")
        clip = cfg.arch == "clip"
        kw = dict(device=device, dtype=dtype)
        patch_dim = cfg.patch_size * cfg.patch_size * 3
        self.patch_embed = Linear(patch_dim, cfg.hidden_size, bias=not clip,
                                  generator=generator, **kw)
        self.pos_embed = _embedding((cfg.num_patches + clip, cfg.hidden_size), generator, **kw)
        if clip:
            self.cls_embed = _embedding((cfg.hidden_size,), generator, **kw)
            self.pre_ln = Norm(cfg.hidden_size, bias=True, **kw)
        self.layers = nn.ModuleList(
            SiglipLayer(cfg, generator=generator, **kw) for _ in range(cfg.num_layers))


def _embedding(shape, generator: Optional[torch.Generator], *, device, dtype) -> nn.Parameter:
    """A learned embedding: N(0, 0.02^2) from `generator`, or uninitialised."""
    x = torch.empty(shape, device=device, dtype=torch.float32 if generator is not None else dtype)
    if generator is not None:
        x = (x.normal_(0.0, 1.0, generator=generator) * 0.02).to(dtype)
    return nn.Parameter(x, requires_grad=False)


def pad_attention_heads(tower: SiglipTower, cfg: VisionConfig, lane: int = 128) -> SiglipTower:
    """A copy of `tower` whose attention heads are zero-padded from head_dim
    to `lane` in the weights (the JAX package's `pad_attention_heads`).

    q, k and v gain zero output columns per head and o matching zero input
    rows, so the projections produce and consume a [T, H, S, lane] layout.
    The numbers are exact: padded q and k lanes are 0, so Q K^T over `lane`
    equals the head_dim contraction; padded v lanes are 0 and meet o's zero
    rows. `_encoder_layer` reads the per-head width from the weights and
    keeps sm_scale = head_dim**-0.5. Dense `Linear`s (w [in, out]) and int8
    `QuantLinear`s (w_qt [out, in], a per-output scale) are padded; biases
    pad with zeros, int8 scales with ones (their rows dequantise exact
    zeros), and the `act_q` markers are kept.
    """
    import copy

    from videoitg_tpu_torch.ops.quant import QuantLinear

    h, d = cfg.num_heads, cfg.head_dim
    if d > lane:
        raise ValueError(f"head_dim {d} is wider than lane {lane}")

    def pad_heads(a: torch.Tensor, dim: int, fill: float = 0.0) -> torch.Tensor:
        # the `dim` axis [H*d] -> [H, d] -> [H, lane] -> [H*lane]
        a = a.movedim(dim, -1)
        lead = a.shape[:-1]
        x = a.reshape(*lead, h, d)
        x = torch.cat([x, x.new_full((*lead, h, lane - d), fill)], dim=-1)
        return x.reshape(*lead, h * lane).movedim(-1, dim).contiguous()

    def param(t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t, requires_grad=False)

    out = copy.deepcopy(tower)
    for layer in out.layers:
        for lin in (layer.q, layer.k, layer.v, layer.o):
            if getattr(lin, "lora_a", None) is not None or getattr(lin, "tp", None) is not None:
                raise ValueError("pad_attention_heads takes a whole tower with no adapters")
            if isinstance(lin, QuantLinear) and lin.bits != 8:
                raise ValueError("pad_attention_heads pads dense and int8 linears only")
        for lin in (layer.q, layer.k, layer.v):  # zero output columns per head
            if isinstance(lin, QuantLinear):
                lin.w_qt = pad_heads(lin.w_qt, 0)
                lin.scale = pad_heads(lin.scale, 0, fill=1.0)
            else:
                lin.w = param(pad_heads(lin.w.data, 1))
            if lin.b is not None:
                lin.b = param(pad_heads(lin.b.data, 0))
        o = layer.o  # zero input rows per head
        if isinstance(o, QuantLinear):
            o.w_qt = pad_heads(o.w_qt, 1)
        else:
            o.w = param(pad_heads(o.w.data, 0))
    return out


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
    quantised from fp32 instead of a round trip through the model dtype.
    Traced, each kernel call is a `linear` span counting the products asked
    of it (its LN, activation, quantisation and residual included in its
    time)."""
    from videoitg_tpu_torch.ops.fused_encoder import (
        fused_ln_mlp_int8,
        fused_ln_qkv_int8,
        fused_proj_residual_int8,
    )

    t, n, h = x.shape
    heads, d = cfg.num_heads, cfg.head_dim
    xf = x.reshape(t * n, h)
    traced = profiling.tracing
    qkv = p.q.out_features + p.k.out_features + p.v.out_features
    with linear_span(t * n, h, qkv, "int8") if traced else profiling.NULL:
        q, k, v = fused_ln_qkv_int8(xf, p.ln1, p.q, p.k, p.v, cfg.layer_norm_eps)
    q, k, v = (a.reshape(t, n, heads, d).transpose(1, 2).contiguous() for a in (q, k, v))
    # As in the JAX package, the kernel attention serves wherever the fused
    # kernels do (the card); on the CPU both take their plain versions.
    attn = mha(q, k, v, valid=None, causal=False, use_flash=x.device.type == "cuda")
    attn = attn.transpose(1, 2).reshape(t * n, heads * d)
    with linear_span(t * n, p.o.in_features, h, "int8") if traced else profiling.NULL:
        x1 = fused_proj_residual_int8(attn, xf, p.o)
    act = "quick_gelu" if cfg.arch == "clip" else "gelu_tanh"
    with linear_span(t * n, h, 2 * p.fc1.out_features, "int8") if traced else profiling.NULL:
        out = fused_ln_mlp_int8(x1, p.ln2, p.fc1, p.fc2, cfg.layer_norm_eps, act=act)
    return out.reshape(t, n, h)


def _fuses(p: SiglipLayer, x: torch.Tensor, use_flash, act8: Act8Switches) -> bool:
    """The gate of the JAX package for the fused act8 layer: the inference
    kernel attention asked for (not the training arm), the switch on, every
    linear int8 + act_q, a q projection that is not padded, and no device
    mesh (under one the fused kernels stay off, as in the JAX package)."""
    from videoitg_tpu_torch.parallel.context import current_attention_mesh

    return (use_flash is True and act8.fused and can_fuse_encoder_layer(p)
            and p.q.out_features == x.shape[-1] and current_attention_mesh() is None)


def _attention(p: SiglipLayer, y: torch.Tensor, cfg: VisionConfig, use_flash,
               act8: Act8Switches) -> torch.Tensor:
    """The attention half of a layer on its normed input y [T, P, H], up to
    o's input: [T, P, heads * d]."""
    t, n, _ = y.shape
    q, k, v = fused_qkv(p.q, p.k, p.v, y, act8)
    tp = getattr(p.q, "tp", None)
    heads = cfg.num_heads // (tp.size if tp is not None else 1)  # a tp rank's own heads
    # The per-head width from the weights: head_dim, or the lane of
    # `pad_attention_heads` (zero columns per head); the scale stays head_dim's.
    d = q.shape[-1] // heads
    # [T, P, H*D] -> [T, H, P, D], contiguous for the kernel.
    q, k, v = (a.reshape(t, n, heads, d).transpose(1, 2).contiguous() for a in (q, k, v))
    attn = mha(q, k, v, valid=None, causal=False, use_flash=use_flash,
               sm_scale=cfg.head_dim ** -0.5)
    return attn.transpose(1, 2).reshape(t, n, heads * d)


def _mlp_hidden(p: SiglipLayer, y: torch.Tensor, cfg: VisionConfig,
                act8: Act8Switches) -> torch.Tensor:
    """act(fc1(y)), fc2's input."""
    act = quick_gelu if cfg.arch == "clip" else gelu_tanh
    return act(linear(p.fc1, y, act8))


def _encoder_layer(p: SiglipLayer, x: torch.Tensor, cfg: VisionConfig,
                   use_flash, act8: Act8Switches) -> torch.Tensor:
    if _fuses(p, x, use_flash, act8):
        return _encoder_layer_fused(p, x, cfg)
    eps = cfg.layer_norm_eps
    x = x + linear(p.o, _attention(p, layer_norm(p.ln1, x, eps), cfg, use_flash, act8), act8)
    y = layer_norm(p.ln2, x, eps)
    return x + linear(p.fc2, _mlp_hidden(p, y, cfg, act8), act8)


def _encoder_layers_carried(layers, x: torch.Tensor, cfg: VisionConfig, use_flash,
                            act8: Act8Switches) -> torch.Tensor:
    """The layers of `_encoder_layer` with `use_flash=True` and no gradient:
    each residual add is carried into the norm after it
    (`ops/layer_norm.add_layer_norm`, one kernel on the card), o's and fc2's
    products leave without their bias, which the same pass adds where the
    linear is a plain dense one. Layer i's fc2 product is layer i+1's
    pending delta; the last one is added plainly, as nothing normalises
    after it. A fused act8 layer takes its input whole. The numbers are
    `_encoder_layer`'s: r bit for bit, y but for the order of the fp32 sums
    on the card."""
    eps = cfg.layer_norm_eps
    pending = (None, None)  # the last fc2 product and its held-back bias
    for p in layers:
        if _fuses(p, x, use_flash, act8):
            if pending[0] is not None:
                x, pending = residual_add(x, *pending), (None, None)
            x = _encoder_layer_fused(p, x, cfg)
            continue
        x, y = add_layer_norm(x, *pending, p.ln1, eps)
        attn = _attention(p, y, cfg, use_flash, act8)
        x, y = add_layer_norm(x, *linear_held_bias(p.o, attn, act8), p.ln2, eps)
        pending = linear_held_bias(p.fc2, _mlp_hidden(p, y, cfg, act8), act8)
    return residual_add(x, *pending) if pending[0] is not None else x


def siglip_features(tower: SiglipTower, images: torch.Tensor, cfg: VisionConfig,
                    use_flash=False,
                    act8: Act8Switches = Act8Switches(),
                    remat: bool = False) -> torch.Tensor:
    """[T, H, W, 3] preprocessed frames -> [T, tokens, hidden] features from
    cfg.num_effective_layers encoder layers, no post-layernorm. `act8` says
    which act8 products run in the hand-written int8 kernels; `remat` (with
    gradients on) recomputes each layer in the backward pass. With
    `use_flash=True` (the inference kernels, not a training arm) and no
    gradient the layers carry each residual add into the norm after it
    (`_encoder_layers_carried`; bf16 on the card, as the kernel takes). For
    arch="clip" the CLS token is prepended, the embeddings pass through the
    pre-layernorm, and the CLS position is dropped again when
    select_feature == "patch"."""
    x = linear(tower.patch_embed, _patchify(images, cfg.patch_size))
    clip = cfg.arch == "clip"
    if clip:
        cls = tower.cls_embed.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
    x = x + tower.pos_embed.to(x.dtype)[None]
    layers = tower.layers[: cfg.num_effective_layers]
    if use_flash is True and not torch.is_grad_enabled():
        if clip:
            x = add_layer_norm(x, None, None, tower.pre_ln, cfg.layer_norm_eps)[1]
        x = _encoder_layers_carried(layers, x, cfg, use_flash, act8)
    else:
        if clip:
            x = layer_norm(tower.pre_ln, x, cfg.layer_norm_eps)
        remat = remat and torch.is_grad_enabled()
        for layer in layers:
            if remat:
                x = checkpoint(_encoder_layer, layer, x, cfg, use_flash, act8,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _encoder_layer(layer, x, cfg, use_flash, act8)
    if clip and cfg.select_feature == "patch":
        x = x[:, 1:]
    return x


def init_siglip(cfg: VisionConfig, generator: torch.Generator, *, device=None,
                dtype=torch.float32) -> SiglipTower:
    """Random tower with the JAX package's distributions (not its bits)."""
    return SiglipTower(cfg, device=device, dtype=dtype, generator=generator)
