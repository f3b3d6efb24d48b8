"""Causal VLM variant: multimodal SFT loss, loglikelihood, KV-cache generation.

Counterpart of videoitg_tpu/models/vlm.py, on the same `GroundingModel`
(the LM's config has `causal=True`; logits come through `qwen2.lm_logits`).

Packing: chat templates put system text BEFORE the image, so the layout is

    [ pre_text | image tokens | post_text | pad ]

with per-segment validity. Positions count the valid tokens before each
slot; the causal mask plus key validity handles the padding, which may sit
mid-sequence.

Generation is two-phase: one causal prefill over the packed prompt that
fills a KV cache, then a greedy decode loop. Where the JAX package compiles
one program with a `lax.while_loop`, this is a Python loop under
`torch.no_grad()` that stops once every sample is done, over a cache
allocated once at `[L, B, Hkv, S_max, D]` and written in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from videoitg_tpu_torch.config import GroundingConfig, LMConfig
from videoitg_tpu_torch.constants import IGNORE_INDEX
from videoitg_tpu_torch.models import qwen2 as qwen2_mod
from videoitg_tpu_torch.models import siglip as siglip_mod
from videoitg_tpu_torch.models.common import apply_rope, linear, rms_norm
from videoitg_tpu_torch.models.grounding import GroundingModel
from videoitg_tpu_torch.models.projector import apply_projector, frame_token_count
from videoitg_tpu_torch.ops.attention import mha
from videoitg_tpu_torch.ops.quant import Act8Switches
from videoitg_tpu_torch.parallel import context as par_context


class VLMBatch(NamedTuple):
    """Packed causal-VLM batch.

    frames:      [B, T, H, W, 3] preprocessed pixels.
    frame_valid: [B, T] bool.
    pre_ids / pre_valid:   [B, L_pre] text before the image block.
    post_ids / post_valid: [B, L_post] text after the image block.
    post_labels: [B, L_post] integer CE targets aligned with post_ids
                 (IGNORE_INDEX outside answer spans), or None at inference.
    """

    frames: torch.Tensor
    frame_valid: torch.Tensor
    pre_ids: torch.Tensor
    pre_valid: torch.Tensor
    post_ids: torch.Tensor
    post_valid: torch.Tensor
    post_labels: Optional[torch.Tensor] = None


def _pack_embeds(model: GroundingModel, batch: VLMBatch, cfg: GroundingConfig, hw: int,
                 use_flash, remat: bool, freeze_vision: bool,
                 act8: Act8Switches = Act8Switches()):
    """(x [B, S, H], valid [B, S], positions [B, S], n_img) of the packed
    layout. `freeze_vision` runs the tower without gradients, so its backward
    never runs; otherwise `remat` recomputes its layers in the backward.
    `act8` says which act8 products of the tower run in the int8 kernels."""
    b, t = batch.frame_valid.shape
    n_pf = frame_token_count(cfg.projector, hw, cfg.vision.num_patches)
    n_img = t * n_pf
    frames_flat = batch.frames.reshape((b * t,) + tuple(batch.frames.shape[2:]))
    if freeze_vision:
        with torch.no_grad():
            feats = siglip_mod.siglip_features(model.vision, frames_flat, cfg.vision,
                                               use_flash=use_flash, act8=act8)
        feats = feats.detach()
    else:
        feats = siglip_mod.siglip_features(model.vision, frames_flat, cfg.vision,
                                           use_flash=use_flash, act8=act8, remat=remat)
    img_tokens = apply_projector(model.projector, feats, cfg.projector, hw=hw)
    img_tokens = img_tokens.reshape(b, n_img, -1)

    pre = qwen2_mod.embed_tokens(model.lm, batch.pre_ids.clamp(min=0))
    post = qwen2_mod.embed_tokens(model.lm, batch.post_ids.clamp(min=0))
    x = torch.cat([pre.to(img_tokens.dtype), img_tokens, post.to(img_tokens.dtype)], dim=1)

    img_valid = batch.frame_valid.repeat_interleave(n_pf, dim=1)
    valid = torch.cat([batch.pre_valid, img_valid, batch.post_valid], dim=1).contiguous()

    # Packed positions: the number of valid tokens before each slot.
    positions = (valid.to(torch.int32).cumsum(dim=1) - 1).clamp(min=0)
    return x, valid, positions, n_img


def _post_token_logprobs(model: GroundingModel, batch: VLMBatch, cfg: GroundingConfig, hw: int,
                         use_flash, remat: bool, freeze_vision: bool,
                         act8: Act8Switches = Act8Switches()):
    """Teacher-forced plumbing shared by `vlm_loss` and `vlm_loglikelihood`:
    (token_logp [B, L_post], greedy [B, L_post], mask [B, L_post])."""
    lm_cfg = cfg.lm
    if not lm_cfg.causal:
        raise ValueError("teacher forcing requires a causal LMConfig")
    x, valid, positions, n_img = _pack_embeds(model, batch, cfg, hw, use_flash, remat,
                                              freeze_vision, act8)
    hidden = qwen2_mod.qwen2_hidden_states(model.lm, x, positions, valid, lm_cfg,
                                           use_flash=use_flash, act8=act8, remat=remat)
    logits = qwen2_mod.lm_logits(model.lm, hidden, lm_cfg)  # [B, S, V] fp32

    l_pre = batch.pre_ids.shape[1]
    l_post = batch.post_ids.shape[1]
    # Post token j is predicted from the hidden state of the previous REAL
    # token: post token j - 1 for j >= 1 (post is a valid prefix), and for
    # j == 0 the last VALID image slot, since padded pre / image slots sit
    # between the segments.
    post_start = l_pre + n_img
    pred_logits = logits[:, post_start - 1: post_start - 1 + l_post]
    n_pf = frame_token_count(cfg.projector, hw, cfg.vision.num_patches)
    n_valid_img = batch.frame_valid.sum(dim=1) * n_pf
    boundary_idx = l_pre + n_valid_img - 1  # last valid image slot per sample
    boundary_logits = logits[torch.arange(logits.shape[0], device=logits.device),
                             boundary_idx][:, None]  # [B, 1, V]
    pred_logits = torch.cat([boundary_logits, pred_logits[:, 1:]], dim=1)
    labels = batch.post_labels
    mask = (labels != IGNORE_INDEX) & batch.post_valid

    logp = F.log_softmax(pred_logits, dim=-1)
    safe_labels = labels.clamp(min=0).long()
    token_logp = logp.gather(-1, safe_labels[..., None])[..., 0]
    greedy = pred_logits.argmax(dim=-1) == safe_labels
    return token_logp, greedy, mask


def vlm_loss(model: GroundingModel, batch: VLMBatch, cfg: GroundingConfig, hw: int,
             use_flash=False, remat: bool = True, freeze_vision: bool = True):
    """Next-token CE over the post-text answer tokens. `use_flash=True` means
    the differentiable kernels ("train"), in the tower as well; a string
    ("train", "train-jax") is passed through. Returns (loss, metrics) with
    metrics `loss` and `num_label_tokens` (detached 0-d tensors)."""
    if batch.post_labels is None:
        raise ValueError("vlm_loss needs batch.post_labels")
    if use_flash is True:
        use_flash = "train"
    token_logp, _, mask = _post_token_logprobs(model, batch, cfg, hw, use_flash, remat,
                                               freeze_vision)
    # Under a dp mesh the token count is the whole batch's (each rank's loss
    # its share of the whole-batch mean).
    n, = par_context.sum_over_dp(mask.sum())
    loss = -(token_logp * mask).sum() / n.clamp(min=1).to(token_logp.dtype)
    return loss, {"loss": par_context.sum_over_dp(loss.detach())[0], "num_label_tokens": n}


def vlm_loglikelihood(model: GroundingModel, batch: VLMBatch, cfg: GroundingConfig, hw: int,
                      use_flash=False, act8: Act8Switches = Act8Switches()
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (loglikelihood [B] fp32, is_greedy [B] bool) of the labelled
    continuation: the summed logprob of the tokens with a label, and whether
    each of them is the greedy prediction. No gradients. `act8` says which
    act8 products run in the int8 kernels."""
    if batch.post_labels is None:
        raise ValueError("vlm_loglikelihood needs batch.post_labels")
    with torch.no_grad():
        token_logp, greedy, mask = _post_token_logprobs(model, batch, cfg, hw, use_flash,
                                                        remat=False, freeze_vision=True,
                                                        act8=act8)
        ll = (token_logp * mask).sum(dim=1)
        is_greedy = (greedy | ~mask).all(dim=1)
    return ll, is_greedy


# ---- KV-cache generation -------------------------------------------------


@dataclass
class KVCache:
    """Allocated once by `vlm_prefill`; `vlm_decode_step` writes into it."""

    k: torch.Tensor         # [L, B, Hkv, S_max, D]
    v: torch.Tensor
    mask: torch.Tensor      # [B, S_max] bool: which cache slots hold real keys
    write_idx: int          # next slot to write (shared by the batch)
    next_pos: torch.Tensor  # [B] next RoPE position per sample


def _attend_with_cache(q, k_cache, v_cache, mask):
    """q [B, Hq, 1, D] against cache [B, Hkv, S, D]; `mask` [B, S] marks real
    keys (a packed prompt may have pad holes mid-sequence). fp32 softmax."""
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    qf = q.reshape(b, hkv, hq // hkv, d)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf.float(), k_cache.float()) * d ** -0.5
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _project_qkv(layer, y, positions, cfg: LMConfig, act8: Act8Switches):
    b, s, _ = y.shape
    q = linear(layer.q, y, act8).reshape(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = linear(layer.k, y, act8).reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = linear(layer.v, y, act8).reshape(b, s, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    return (apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta),
            v.contiguous())


def _mlp(layer, x, cfg: LMConfig, act8: Act8Switches):
    y = rms_norm(layer.post_attn_norm, x, cfg.rms_norm_eps)
    return x + linear(layer.down, F.silu(linear(layer.gate, y, act8)) * linear(layer.up, y, act8),
                      act8)


def vlm_prefill(lm: qwen2_mod.Qwen2, x: torch.Tensor, valid: torch.Tensor,
                positions: torch.Tensor, cfg: LMConfig, max_len: int,
                use_flash=False, act8: Act8Switches = Act8Switches()
                ) -> Tuple[torch.Tensor, KVCache]:
    """Causal prefill that fills a KV cache of `max_len` slots.

    `valid` may have pad holes mid-sequence (the packed [pre | img | post]
    layout pads each segment); the cache keeps them in its mask, and the
    hidden state returned is the one at each sample's LAST VALID slot.
    `use_flash=True` takes the streaming inference kernel with `causal=True`;
    `act8` says which act8 linears run in the int8 kernel.
    """
    b, s, _ = x.shape
    layers = lm.layers[: cfg.num_layers]
    shape = (len(layers), b, cfg.num_kv_heads, max_len, cfg.head_dim)
    k_all = torch.zeros(shape, dtype=x.dtype, device=x.device)
    v_all = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, layer in enumerate(layers):
        y = rms_norm(layer.input_norm, x, cfg.rms_norm_eps)
        q, k, v = _project_qkv(layer, y, positions, cfg, act8)
        k_all[i, :, :, :s] = k
        v_all[i, :, :, :s] = v
        attn = mha(q, k, v, valid=valid, causal=True, use_flash=use_flash)
        x = x + linear(layer.o, attn.transpose(1, 2).reshape(b, s, cfg.q_dim), act8)
        x = _mlp(layer, x, cfg, act8)
    hidden = rms_norm(lm.final_norm, x, cfg.rms_norm_eps)

    mask = F.pad(valid, (0, max_len - s))
    # positions = cumsum(valid) - 1 never decreases: its first maximum sits at
    # the last valid slot of each sample.
    last_valid_idx = positions.argmax(dim=1)
    last_hidden = hidden[torch.arange(b, device=x.device), last_valid_idx]  # [B, H]
    next_pos = valid.sum(dim=1)
    return last_hidden, KVCache(k=k_all, v=v_all, mask=mask, write_idx=s, next_pos=next_pos)


def vlm_decode_step(model, token: torch.Tensor, cache: KVCache, cfg: LMConfig,
                    act8: Act8Switches = Act8Switches()) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: token [B] -> (logits [B, V] fp32, the cache). `model`
    is the `GroundingModel` or its LM. The cache is updated IN PLACE and
    returned: slot `write_idx` of every layer gets the new key and value.
    `act8` says which act8 linears run in the int8 kernel (at M = B rows)."""
    lm = model.lm if hasattr(model, "lm") else model
    b = token.shape[0]
    x = qwen2_mod.embed_tokens(lm, token)[:, None, :]
    pos = cache.next_pos[:, None]  # [B, 1] RoPE position per sample
    w = cache.write_idx
    cache.mask[:, w] = True
    seen = cache.mask[:, : w + 1]  # later slots are empty: leaving them out changes nothing
    for i, layer in enumerate(lm.layers[: cfg.num_layers]):
        y = rms_norm(layer.input_norm, x, cfg.rms_norm_eps)
        q, k, v = _project_qkv(layer, y, pos, cfg, act8)
        cache.k[i, :, :, w] = k[:, :, 0]
        cache.v[i, :, :, w] = v[:, :, 0]
        attn = _attend_with_cache(q, cache.k[i, :, :, : w + 1], cache.v[i, :, :, : w + 1], seen)
        x = x + linear(layer.o, attn.transpose(1, 2).reshape(b, 1, cfg.q_dim), act8)
        x = _mlp(layer, x, cfg, act8)
    hidden = rms_norm(lm.final_norm, x, cfg.rms_norm_eps)
    logits = qwen2_mod.lm_logits(lm, hidden, cfg)[:, 0]
    cache.write_idx = w + 1
    cache.next_pos = cache.next_pos + 1
    return logits, cache


def vlm_generate(model: GroundingModel, batch: VLMBatch, cfg: GroundingConfig, hw: int,
                 max_new_tokens: int = 16, eos_token_id: int = -1, use_flash=False,
                 stop_sequences: Sequence[Sequence[int]] = (),
                 act8: Act8Switches = Act8Switches()) -> torch.Tensor:
    """Greedy generation. Returns [B, max_new_tokens] int32 token ids, padded
    with `eos_token_id` after a sample is done.

    A sample is done after it emits eos, or once its trailing tokens match one
    of `stop_sequences` (token-id sequences): the stop is live, it halts the
    loop and does not merely cut the text (`truncate_at_stop_sequences` still
    cuts it afterwards). The loop ends when every sample is done. `act8`
    says which act8 products (tower, prefill, decode) run in the int8 kernels.
    """
    lm_cfg = cfg.lm
    if not lm_cfg.causal:
        raise ValueError("generation requires a causal LMConfig")
    with torch.no_grad():
        x, valid, positions, _ = _pack_embeds(model, batch, cfg, hw, use_flash, remat=False,
                                              freeze_vision=True, act8=act8)
        b, dev = x.shape[0], x.device
        last_hidden, cache = vlm_prefill(model.lm, x, valid, positions, lm_cfg,
                                         x.shape[1] + max_new_tokens, use_flash=use_flash,
                                         act8=act8)
        tok = qwen2_mod.lm_logits(model.lm, last_hidden[:, None, :], lm_cfg)[:, 0].argmax(dim=-1)
        out = torch.full((b, max_new_tokens), eos_token_id, dtype=torch.int32, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        stops = [torch.tensor(list(seq), dtype=torch.int32, device=dev) for seq in stop_sequences
                 if 0 < len(seq) <= max_new_tokens]
        for i in range(max_new_tokens):
            out[:, i] = torch.where(done, eos_token_id, tok.to(torch.int32))
            done = done | (tok == eos_token_id)
            for seq in stops:
                n = seq.shape[0]
                if i + 1 >= n:
                    done = done | (out[:, i + 1 - n: i + 1] == seq[None]).all(dim=1)
            if i + 1 == max_new_tokens or bool(done.all()):
                break
            logits, cache = vlm_decode_step(model, tok, cache, lm_cfg, act8)
            tok = logits.argmax(dim=-1)
    return out


def truncate_at_stop_sequences(tokens, stop_sequences: Optional[list] = None,
                               eos_token_id: int = -1) -> list:
    """Host-side keyword stopping: cut each row at eos or at the first
    occurrence of any stop token-sequence. Returns a list of token lists."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    rows = []
    for row in np.asarray(tokens):
        toks = row.tolist()
        if eos_token_id in toks:
            toks = toks[: toks.index(eos_token_id)]
        cut = len(toks)
        for seq in stop_sequences or []:
            n = len(seq)
            for i in range(len(toks) - n + 1):
                if toks[i: i + n] == list(seq):
                    cut = min(cut, i)
                    break
        rows.append(toks[:cut])
    return rows
