"""VideoITG grounding model: frames + instruction -> per-frame relevance logits.

Counterpart of videoitg_tpu/models/grounding.py. SigLIP features per frame ->
seq_mlp projector -> the static packed layout

    [ T_bucket * hw^2 image slots | max_text_len text slots ]

with validity masks and packed positions (image slot i -> i, text slot j ->
number of valid image tokens + j) -> bidirectional Qwen2 -> fp32 per-frame
mean pool of the image slots -> Linear(hidden, 1) -> [B, T] logits, -inf on
bucket-padding frames. `grounding_loss` is the training objective: masked
BCE-with-logits with pos_weight = min(cap, sqrt(neg / pos)) over the batch.
The causal VLM variant (models/vlm.py) runs on the same `GroundingModel`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models import qwen2 as qwen2_mod
from videoitg_tpu_torch.models import siglip as siglip_mod
from videoitg_tpu_torch.models.common import Linear, linear_span
from videoitg_tpu_torch.models.projector import Projector, apply_projector, frame_token_count
from videoitg_tpu_torch.ops.quant import Act8Switches
from videoitg_tpu_torch.parallel import context as par_context
from videoitg_tpu_torch.utils import profiling


class GroundingModel(nn.Module):
    """vision / projector / lm / out_proj, named as in the JAX params tree.
    The causal VLM is the same module: `with_lm_head` gives an untied LM its
    output head, and `with_out_proj=False` leaves the scoring head out, as a
    converted VLM checkpoint's tree does (a random-init VLM keeps it, unused,
    exactly as the JAX package's `init_grounding` does). `lm` takes an LM built
    elsewhere, such as one drawn directly in int8 form (ops/quant.init_qwen2_int8)."""

    def __init__(self, cfg: GroundingConfig, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, with_lm_head: bool = False,
                 with_out_proj: bool = True, lm: Optional[nn.Module] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.vision = siglip_mod.SiglipTower(cfg.vision, **kw)
        self.projector = Projector(cfg.projector, **kw)
        self.lm = lm if lm is not None else qwen2_mod.Qwen2(
            cfg.lm, with_lm_head=with_lm_head, **kw)
        if not with_out_proj:
            return
        self.out_proj = Linear(cfg.lm.hidden_size, 1, device=device, dtype=dtype)
        if generator is not None:
            # Xavier-uniform head (reference grounding_qwen2.py:79-80).
            bound = (6.0 / (cfg.lm.hidden_size + 1)) ** 0.5
            w = torch.empty(cfg.lm.hidden_size, 1, device=device, dtype=torch.float32)
            self.out_proj.w.data = w.uniform_(-bound, bound, generator=generator).to(dtype)


def init_grounding(cfg: GroundingConfig, generator: torch.Generator, *, device=None,
                   dtype=torch.float32) -> GroundingModel:
    """Random model drawn from `generator` with the JAX package's
    distributions (the same laws, not the same bits)."""
    return GroundingModel(cfg, device=device, dtype=dtype, generator=generator)


class GroundingBatch(NamedTuple):
    """One static-shape scoring batch.

    frames:      [B, T, H, W, 3] preprocessed pixels, or [B, T, P, C]
                 precomputed tower features (the tower is skipped).
    frame_valid: [B, T] bool — False marks bucket-padding frames.
    text_ids:    [B, L] integer, right-padded.
    text_valid:  [B, L] bool.
    labels:      [B, T] 0/1 grounding labels, or None at inference.
    """

    frames: torch.Tensor
    frame_valid: torch.Tensor
    text_ids: torch.Tensor
    text_valid: torch.Tensor
    labels: Optional[torch.Tensor] = None


def vision_features(model: GroundingModel, frames: torch.Tensor, cfg: GroundingConfig,
                    use_flash=False, vision_chunk: int = 0,
                    act8: Act8Switches = Act8Switches(), remat: bool = False) -> torch.Tensor:
    """[N, H, W, 3] preprocessed frames -> [N, P, C] tower features. With
    vision_chunk > 0 the tower runs over chunks of that many frames when N is
    a larger multiple of it, bounding its activations."""
    n = frames.shape[0]
    if vision_chunk and n > vision_chunk and n % vision_chunk == 0:
        return torch.cat([siglip_mod.siglip_features(model.vision, chunk, cfg.vision,
                                                     use_flash=use_flash, act8=act8,
                                                     remat=remat)
                          for chunk in frames.split(vision_chunk)])
    return siglip_mod.siglip_features(model.vision, frames, cfg.vision, use_flash=use_flash,
                                      act8=act8, remat=remat)


def grounding_logits(model: GroundingModel, batch: GroundingBatch, cfg: GroundingConfig,
                     hw: int, use_flash=False, vision_chunk: int = 0,
                     act8: Act8Switches = Act8Switches(), remat: bool = False,
                     freeze_vision: bool = False,
                     lm_splash: Optional[bool] = None) -> torch.Tensor:
    """Per-frame relevance logits [B, T] (invalid frames -> -inf);
    vision_chunk as in `vision_features`. A 4-d `batch.frames` holds tower
    features [B, T, P, C] and skips the tower. `freeze_vision` runs the tower
    without gradients and detaches its output, so its backward never runs;
    `remat` recomputes each layer of the tower and of the LM in the backward
    pass. `lm_splash` is the LM's serving A/B switch (`ops/attention.mha`)."""
    b, t = batch.frame_valid.shape
    n_pf = frame_token_count(cfg.projector, hw, cfg.vision.num_patches)
    frames_flat = batch.frames.reshape((b * t,) + tuple(batch.frames.shape[2:]))
    if batch.frames.dim() == 4:
        feats = frames_flat  # [B*T, P, C]
    elif freeze_vision:
        with torch.no_grad():
            feats = vision_features(model, frames_flat, cfg, use_flash=use_flash,
                                    vision_chunk=vision_chunk, act8=act8)
    else:
        feats = vision_features(model, frames_flat, cfg, use_flash=use_flash,
                                vision_chunk=vision_chunk, act8=act8, remat=remat)
    if freeze_vision:
        feats = feats.detach()
    img_tokens = apply_projector(model.projector, feats, cfg.projector, hw=hw)
    img_tokens = img_tokens.reshape(b, t * n_pf, -1)
    return grounding_logits_from_tokens(model, img_tokens, batch.frame_valid, batch.text_ids,
                                        batch.text_valid, cfg, n_pf=n_pf, use_flash=use_flash,
                                        act8=act8, remat=remat, lm_splash=lm_splash)


def grounding_logits_from_tokens(model: GroundingModel, img_tokens: torch.Tensor,
                                 frame_valid: torch.Tensor, text_ids: torch.Tensor,
                                 text_valid: torch.Tensor, cfg: GroundingConfig, n_pf: int,
                                 use_flash=False,
                                 act8: Act8Switches = Act8Switches(),
                                 remat: bool = False,
                                 lm_splash: Optional[bool] = None) -> torch.Tensor:
    """LM + head over already-projected image tokens [B, T*n_pf, D]."""
    b, t = frame_valid.shape
    l_txt = text_ids.shape[1]
    n_img = t * n_pf
    device = img_tokens.device

    txt_tokens = qwen2_mod.embed_tokens(model.lm, text_ids.clamp(min=0))
    x = torch.cat([img_tokens, txt_tokens.to(img_tokens.dtype)], dim=1)

    img_valid = frame_valid.repeat_interleave(n_pf, dim=1)  # [B, n_img]
    valid = torch.cat([img_valid, text_valid], dim=1).contiguous()  # [B, S]

    # Valid image tokens form a prefix: image slot i sits at position i, text
    # token j right after the last valid image token.
    n_valid_img = img_valid.sum(dim=1, keepdim=True)
    img_pos = torch.arange(n_img, device=device).expand(b, n_img)
    txt_pos = n_valid_img + torch.arange(l_txt, device=device)[None]
    positions = torch.cat([img_pos, txt_pos], dim=1)

    hidden = qwen2_mod.qwen2_hidden_states(model.lm, x, positions, valid, cfg.lm,
                                           use_flash=use_flash, act8=act8, remat=remat,
                                           lm_splash=lm_splash)
    # Per-frame fp32 mean pool of the image slots (reference grounding_qwen2.py:148-156).
    frame_hidden = hidden[:, :n_img].reshape(b, t, n_pf, -1).float().mean(dim=2)
    with (linear_span(b * t, frame_hidden.shape[-1], 1, "bf16") if profiling.tracing
          else profiling.NULL):
        logits = (frame_hidden @ model.out_proj.w.float() + model.out_proj.b.float())[..., 0]
    return logits.masked_fill(~frame_valid, float("-inf"))


def grounding_loss(model: GroundingModel, batch: GroundingBatch, cfg: GroundingConfig, hw: int,
                   use_flash=False, remat: bool = True, freeze_vision: bool = True):
    """Masked BCE-with-logits in fp32 with pos_weight = min(cfg.max_pos_weight,
    sqrt(neg / max(1, pos))), the weight from the whole batch's labels and the
    mean over all valid frames (under a dp mesh: the whole batch's, each
    rank's loss its share of it). `use_flash=True` means the differentiable
    kernels ("train"), in the tower as well. Returns (loss, metrics) with
    metrics `loss`, `pos_weight`, `pos_frac` (detached 0-d tensors)."""
    if batch.labels is None:
        raise ValueError("grounding_loss needs batch.labels")
    if use_flash is True:
        use_flash = "train"
    logits = grounding_logits(model, batch, cfg, hw, use_flash=use_flash, remat=remat,
                              freeze_vision=freeze_vision)
    mask = batch.frame_valid.float()
    labels = batch.labels.float() * mask
    logits = logits.masked_fill(~batch.frame_valid, 0.0).float()

    # Under a dp mesh the statistics are the whole batch's (each rank's loss
    # is its share of the whole-batch mean, so the losses and gradients sum
    # over dp).
    pos, total = par_context.sum_over_dp(labels.sum(), mask.sum())
    neg = total - pos
    pos_weight = torch.sqrt(neg / pos.clamp(min=1.0)).clamp(max=float(cfg.max_pos_weight))

    per_elem = -(pos_weight * labels * F.logsigmoid(logits)
                 + (1.0 - labels) * F.logsigmoid(-logits))
    loss = (per_elem * mask).sum() / total.clamp(min=1.0)
    metrics = {"loss": par_context.sum_over_dp(loss.detach())[0], "pos_weight": pos_weight,
               "pos_frac": pos / total.clamp(min=1.0)}
    return loss, metrics
