"""Qwen2-style decoder LM in PyTorch.

Counterpart of videoitg_tpu/models/qwen2.py: Qwen2-7B (hidden 3584, 28 layers,
28 q / 4 kv heads, SwiGLU 18944, RMSNorm eps 1e-6, RoPE theta 1e6, q/k/v
bias). The grounding LM runs every layer bidirectionally (cfg.causal is
False) with no KV cache, over pre-computed input embeddings and explicit
position ids. `remat=True` recomputes each layer in the backward pass
(`torch.utils.checkpoint`, the counterpart of `jax.checkpoint` with nothing
saved). The causal VLM (models/vlm.py) runs the same stack with cfg.causal
True and reads next-token logits through `lm_logits`: the tied embedding, or
an `lm_head` of its own when the config is untied and a head was asked for.
The pipeline-parallel branch waits (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from videoitg_tpu_torch.config import LMConfig
from videoitg_tpu_torch.models.common import (
    Linear,
    Norm,
    apply_rope,
    fused_qkv,
    linear,
    new_param,
    rms_norm,
)
from videoitg_tpu_torch.ops.attention import mha
from videoitg_tpu_torch.ops.quant import Act8Switches


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = new_param((vocab, dim), device, dtype, generator, 0.02)


class Qwen2Layer(nn.Module):
    """Norms and the seven linears of a decoder layer. `dense_linears=False`
    leaves the linears out, for a caller that sets them in another form
    (ops/quant.init_qwen2_int8)."""

    def __init__(self, cfg: LMConfig, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, dense_linears: bool = True):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        lin = dict(kw, generator=generator)
        self.input_norm = Norm(h, bias=False, **kw)
        self.post_attn_norm = Norm(h, bias=False, **kw)
        if not dense_linears:
            return
        self.q = Linear(h, cfg.q_dim, bias=cfg.qkv_bias, **lin)
        self.k = Linear(h, cfg.kv_dim, bias=cfg.qkv_bias, **lin)
        self.v = Linear(h, cfg.kv_dim, bias=cfg.qkv_bias, **lin)
        self.o = Linear(cfg.q_dim, h, bias=False, **lin)
        self.gate = Linear(h, m, bias=False, **lin)
        self.up = Linear(h, m, bias=False, **lin)
        self.down = Linear(m, h, bias=False, **lin)


class Qwen2(nn.Module):
    """Parameters of the LM; `qwen2_hidden_states` runs it. `with_lm_head`
    adds the untied output head of the causal VLM (`lm_head`, [hidden, vocab],
    no bias); a config with tied embeddings never has one."""

    def __init__(self, cfg: LMConfig, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, dense_linears: bool = True,
                 with_lm_head: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = Embed(cfg.vocab_size, cfg.hidden_size, generator=generator, **kw)
        self.layers = nn.ModuleList(
            Qwen2Layer(cfg, generator=generator, dense_linears=dense_linears, **kw)
            for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.hidden_size, bias=False, **kw)
        if with_lm_head and not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                  generator=generator, **kw)


def embed_tokens(lm: Qwen2, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; ids may hold padding (callers mask)."""
    return lm.embed.w[ids]


def _decoder_layer(p: Qwen2Layer, x: torch.Tensor, positions: torch.Tensor,
                   valid: Optional[torch.Tensor], cfg: LMConfig, use_flash,
                   act8: Act8Switches, lm_splash: Optional[bool] = None) -> torch.Tensor:
    b, s, _ = x.shape
    y = rms_norm(p.input_norm, x, cfg.rms_norm_eps)
    q, k, v = fused_qkv(p.q, p.k, p.v, y, act8)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2).contiguous()
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn = mha(q, k, v, valid=valid, causal=cfg.causal, use_flash=use_flash,
               lm_splash=lm_splash)
    x = x + linear(p.o, attn.transpose(1, 2).reshape(b, s, cfg.q_dim), act8)
    y = rms_norm(p.post_attn_norm, x, cfg.rms_norm_eps)
    return x + linear(p.down, F.silu(linear(p.gate, y, act8)) * linear(p.up, y, act8), act8)


def qwen2_hidden_states(lm: Qwen2, inputs_embeds: torch.Tensor, positions: torch.Tensor,
                        valid: Optional[torch.Tensor], cfg: LMConfig,
                        use_flash=False,
                        act8: Act8Switches = Act8Switches(),
                        remat: bool = False,
                        lm_splash: Optional[bool] = None) -> torch.Tensor:
    """Run the decoder stack; returns final-norm hidden states [B, S, H].
    With `remat` (and gradients on) each layer keeps only its input and is
    run again in the backward pass. `lm_splash` is the serving A/B switch of
    `ops/attention.mha` (None reads VIDEOITG_LM_SPLASH)."""
    x = inputs_embeds
    remat = remat and torch.is_grad_enabled()
    for layer in lm.layers[: cfg.num_layers]:
        if remat:
            x = checkpoint(_decoder_layer, layer, x, positions, valid, cfg, use_flash, act8,
                           lm_splash, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _decoder_layer(layer, x, positions, valid, cfg, use_flash, act8, lm_splash)
    return rms_norm(lm.final_norm, x, cfg.rms_norm_eps)


def lm_logits(lm: Qwen2, hidden: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """LM head of the causal VLM: hidden [B, S, H] -> fp32 logits [B, S, V],
    through the transposed embedding when `cfg.tie_word_embeddings`, else
    through `lm_head`. Operands are raised to fp32 before the product (bf16
    products are exact in fp32, so this is the JAX package's bf16 operands
    with fp32 accumulation), which costs one fp32 copy of the weight."""
    if cfg.tie_word_embeddings:
        return hidden.float() @ lm.embed.w.float().t()
    return hidden.float() @ lm.lm_head.w.float()


def init_qwen2(cfg: LMConfig, generator: torch.Generator, *, device=None,
               dtype=torch.float32, with_lm_head: bool = False) -> Qwen2:
    """Random LM with the JAX package's distributions (not its bits)."""
    return Qwen2(cfg, device=device, dtype=dtype, generator=generator,
                 with_lm_head=with_lm_head)
