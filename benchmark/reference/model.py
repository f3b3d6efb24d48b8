"""VideoITG grounding in plain float32 PyTorch, from the published description.

Frames + instruction -> one relevance score per frame, as the released
model computes it:

* preprocess: HF SiglipImageProcessor, i.e. PIL's BICUBIC resize of the
  uint8 RGB frame to 384 x 384 in PIL's own 22-bit fixed point (horizontal
  pass, rounded and clipped to uint8, then vertical), rescale by 1/255,
  normalise with mean = std = 0.5;
* tower: SigLIP, the output of the second-to-last encoder layer (no post
  LayerNorm); patches flattened in (kh, kw, c) order, the layout of the
  weights' `patch_embed.w`;
* projector (seq_mlp): each frame's sqrt(P) x sqrt(P) grid resized to hw x hw
  as torch's bilinear `interpolate(align_corners=False)` does, hw =
  floor(sqrt(vision_token_num / T)) clamped to the grid, then Linear, erf
  GELU, Linear;
* LM: the packed sequence [T * hw^2 image tokens | instruction tokens] through
  a bidirectional Qwen2 (RMSNorm, q/k/v biases, RoPE rotate-half, grouped
  query attention, SwiGLU); image token i at position i, text token j at
  T * hw^2 + j; padding slots are left out, which is exact, since no valid
  token attends to them;
* head: per-frame mean of the final hidden states of the frame's image
  tokens, Linear(hidden, 1), sigmoid.

The `act8` tier is the same model with every tower and LM encoder linear in
int8: the weight per output channel (scale = amax / 127, a zero column 1,
round half to even, clip to +-127) and the activation per row (the same
formula on the row's amax), the integer product summed exactly (in float64),
then both scales, then the bias. `int4` is the LM's linears' weights in
int4 (amax / 7, clip to +-7), activations left in floating point. `fp8` is
every tower and LM encoder linear in float8 e4m3, the weight scaled per
output channel and the activation per row to the format's largest value
(448), the product in float32.

Everything runs in float32 with TF32 off (float64 where it says so), layer by
layer and in blocks of frames and of query rows, so that an 8B model fits one
card beside its bfloat16 weights. It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


def char_ids(instruction: str, vocab_size: int, max_len: int) -> List[int]:
    """The grounding prompt's text after the image block ("<image>" +
    instruction + "\\n"), one id per character (ord mod vocab)."""
    return [ord(c) % vocab_size for c in instruction + "\n"][:max_len]


# ---- preprocess ----


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def pil_fixed_point_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] integer coefficients of PIL's BICUBIC resample
    (libImaging/Resample.c: precompute_coeffs, normalize_coeffs_8bpc)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    out = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [_bicubic((x + xmin - center + 0.5) / filterscale) for x in range(xmax - xmin)]
        total = sum(w)
        for x, wx in enumerate(w):
            k = wx / total if total != 0.0 else wx
            # C's (int) truncates toward zero after the +-0.5
            out[xx, xmin + x] = math.trunc(k * (1 << PRECISION_BITS) + (-0.5 if k < 0 else 0.5))
    return out


def _resample_pass(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """One PIL pass over the last axis: 2^21 + sum(pixel * k), shifted right
    by 22 and clipped to [0, 255]. float64 holds every sum exactly."""
    acc = torch.matmul(x, coeffs.t()) + float(1 << (PRECISION_BITS - 1))
    return torch.clamp(torch.floor(acc / float(1 << PRECISION_BITS)), 0.0, 255.0)


def preprocess(frames_u8: torch.Tensor, size: int, block: int = 32) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> float32 [T, size, size, 3], normalised to [-1, 1]."""
    t, h, w, _ = frames_u8.shape
    dev = frames_u8.device
    cw = torch.from_numpy(pil_fixed_point_coeffs(w, size)).to(dev)
    ch = torch.from_numpy(pil_fixed_point_coeffs(h, size)).to(dev)
    out = []
    for i in range(0, t, block):
        x = frames_u8[i: i + block].to(torch.float64).permute(0, 3, 1, 2)  # [b, 3, H, W]
        x = _resample_pass(x, cw)                                         # [b, 3, H, S]
        x = _resample_pass(x.transpose(-1, -2), ch).transpose(-1, -2)     # [b, 3, S, S]
        x = x.permute(0, 2, 3, 1).to(torch.float32)
        out.append((x / 255.0 - 0.5) / 0.5)
    return torch.cat(out)


# ---- linears, plain and quantised ----


def _quant_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    return torch.where(amax == 0, torch.ones_like(amax),
                       amax / torch.tensor(qmax, dtype=amax.dtype, device=amax.device))


def quantize_weight(w: torch.Tensor, qmax: float):
    """[in, out] -> (integer values as float64 [in, out], fp32 scale [out])."""
    w = w.float()
    scale = _quant_scale(w.abs().amax(dim=0), qmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return q.to(torch.float64), scale


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`."""
    scale = _quant_scale(x.abs().amax(dim=dim, keepdim=True), 448.0)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


TOWER_TIERS = ("act8", "fp8")        # tiers that change the tower's linears
LM_TIERS = ("act8", "int4", "fp8")   # and the LM's


class Linears:
    """Reads a weight dict as float32 linears in one tier: None (floating
    point), 'act8' (int8 weights and rows, for the keys it quantises),
    'int4' (int4 weights of the keys it quantises) or 'fp8' (e4m3 weights
    and rows)."""

    def __init__(self, sd: Dict[str, torch.Tensor], tier: Optional[str]):
        self.sd, self.tier = sd, tier

    def __call__(self, name: str, x: torch.Tensor, quantised: bool = False) -> torch.Tensor:
        w = self.sd[f"{name}.w"]
        b = self.sd.get(f"{name}.b")
        if quantised and self.tier == "act8":
            wq, ws = quantize_weight(w, 127.0)
            lead = x.shape[:-1]
            x2 = x.reshape(-1, x.shape[-1]).float()
            xs = _quant_scale(x2.abs().amax(dim=-1, keepdim=True), 127.0)
            xq = torch.clamp(torch.round(x2 / xs), -127.0, 127.0).to(torch.float64)
            y = (torch.matmul(xq, wq).float() * xs * ws).reshape(*lead, -1)
        elif quantised and self.tier == "int4":
            wq, ws = quantize_weight(w, 7.0)
            y = torch.matmul(x.float(), wq.float()) * ws
        elif quantised and self.tier == "fp8":
            y = torch.matmul(fp8_round(x.float(), -1), fp8_round(w.float(), 0))
        else:
            y = torch.matmul(x.float(), w.float())
        if b is not None:
            y = y + b.float()
        return y


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).pow(2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale.float()


# ---- tower ----


def effective_layers(v: dict) -> int:
    """Encoder layers that run: select_layer indexes the hidden states
    [embeddings, layer 1, ..., layer N], counting from the end when negative."""
    sel = v["select_layer"]
    return v["num_layers"] + 1 + sel if sel < 0 else sel


def tower(sd, lin: Linears, v: dict, pix: torch.Tensor, block: int = 64) -> torch.Tensor:
    """[T, S, S, 3] -> [T, P, C]: the hidden state that select_layer names."""
    p, c, heads = v["patch_size"], v["hidden_size"], v["num_heads"]
    d = c // heads
    n_run = effective_layers(v)
    quantised = lin.tier in TOWER_TIERS
    out = []
    for i in range(0, pix.shape[0], block):
        x = pix[i: i + block]
        t, s = x.shape[0], x.shape[1]
        g = s // p
        x = x[:, : g * p, : g * p].reshape(t, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = lin("vision.patch_embed", x.reshape(t, g * g, p * p * 3))
        x = x + sd["vision.pos_embed"].float()
        n = x.shape[1]
        for layer in range(n_run):
            pre = f"vision.layers.{layer}"
            y = layer_norm(x, sd[f"{pre}.ln1.scale"], sd[f"{pre}.ln1.bias"], v["layer_norm_eps"])
            q, k, vv = (lin(f"{pre}.{name}", y, quantised).reshape(t, n, heads, d).transpose(1, 2)
                        for name in ("q", "k", "v"))
            attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
            a = torch.matmul(attn, vv).transpose(1, 2).reshape(t, n, c)
            x = x + lin(f"{pre}.o", a, quantised)
            y = layer_norm(x, sd[f"{pre}.ln2.scale"], sd[f"{pre}.ln2.bias"], v["layer_norm_eps"])
            x = x + lin(f"{pre}.fc2", F.gelu(lin(f"{pre}.fc1", y, quantised), approximate="tanh"),
                        quantised)
        out.append(x)
    return torch.cat(out)


# ---- projector ----


def bilinear_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """[out, in] weights of torch's bilinear interpolate, align_corners=False."""
    m = torch.zeros(out_size, in_size, dtype=torch.float64)
    scale = in_size / out_size
    for o in range(out_size):
        src = max((o + 0.5) * scale - 0.5, 0.0)
        i0 = min(int(math.floor(src)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        frac = src - i0
        m[o, i0] += 1.0 - frac
        m[o, i1] += frac
    return m.float()


def inference_hw(p: dict, n_frames: int, grid: int) -> int:
    return min(math.floor(math.sqrt(p["vision_token_num"] / n_frames)), grid)


def project(lin: Linears, p: dict, feats: torch.Tensor, hw: int) -> torch.Tensor:
    """[T, P, C] -> [T * hw^2, D]."""
    t, n, c = feats.shape
    g = math.isqrt(n)
    x = feats.reshape(t, g, g, c)
    if hw < g:
        m = bilinear_matrix(g, hw).to(feats.device)
        x = torch.einsum("oh,thwc->towc", m, x)
        x = torch.einsum("pw,towc->topc", m, x)
    x = x.reshape(t * hw * hw, c)
    return lin("projector.fc2", F.gelu(lin("projector.fc1", x)))


# ---- LM ----


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, N, D] rotated by positions [N] (rotate-half, float32 angles)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[:, None] * inv_freq[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def lm_frame_logits(sd, lin: Linears, lm: dict, img: torch.Tensor, n_frames: int,
                    text_ids: Sequence[int], q_block: int = 2048) -> torch.Tensor:
    """img [T * n_pf, D] projected tokens + text ids -> [T] float32 logits."""
    quantised = lin.tier in LM_TIERS
    dev = img.device
    ids = torch.tensor(list(text_ids), dtype=torch.long, device=dev)
    x = torch.cat([img.float(), sd["lm.embed.w"][ids].float()])
    n = x.shape[0]
    positions = torch.arange(n, device=dev)
    hq, hkv, d = lm["num_heads"], lm["num_kv_heads"], lm["head_dim"]
    group = hq // hkv
    eps = lm["rms_norm_eps"]
    for layer in range(lm["num_layers"]):
        pre = f"lm.layers.{layer}"
        y = rms_norm(x, sd[f"{pre}.input_norm.scale"], eps)
        q = lin(f"{pre}.q", y, quantised).reshape(n, hq, d).transpose(0, 1)
        k = lin(f"{pre}.k", y, quantised).reshape(n, hkv, d).transpose(0, 1)
        v = lin(f"{pre}.v", y, quantised).reshape(n, hkv, d).transpose(0, 1)
        q, k = rope(q, positions, lm["rope_theta"]), rope(k, positions, lm["rope_theta"])
        q = q.reshape(hkv, group, n, d)
        attn = torch.empty_like(q)
        for i in range(0, n, q_block):
            s = torch.matmul(q[:, :, i: i + q_block], k[:, None].transpose(-1, -2)) * d ** -0.5
            attn[:, :, i: i + q_block] = torch.matmul(torch.softmax(s, dim=-1), v[:, None])
        attn = attn.reshape(hq, n, d).transpose(0, 1).reshape(n, hq * d)
        x = x + lin(f"{pre}.o", attn, quantised)
        y = rms_norm(x, sd[f"{pre}.post_attn_norm.scale"], eps)
        x = x + lin(f"{pre}.down", F.silu(lin(f"{pre}.gate", y, quantised))
                    * lin(f"{pre}.up", y, quantised), quantised)
        del q, k, v, attn, y
    x = rms_norm(x, sd["lm.final_norm.scale"], eps)
    frame_hidden = x[: img.shape[0]].reshape(n_frames, -1, x.shape[-1]).mean(dim=1)
    return (frame_hidden @ sd["out_proj.w"].float() + sd["out_proj.b"].float())[:, 0]


# ---- whole model ----


def encode(sd, cfg: dict, frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> projected image tokens [T * hw^2, D] (float32)."""
    m = cfg["model"]
    v = m["vision"]
    lin = Linears(sd, cfg.get("tier"))
    feats = tower(sd, lin, v, preprocess(frames_u8, v["image_size"]))
    hw = inference_hw(m["projector"], frames_u8.shape[0], v["image_size"] // v["patch_size"])
    return project(lin, m["projector"], feats, hw)


def scores(sd, cfg: dict, img: torch.Tensor, n_frames: int, instruction: str) -> np.ndarray:
    """Sigmoid scores [T] (float64) of one instruction against encoded image
    tokens: the float32 logits, then the sigmoid in float64, so that no
    rounding of the reference's own hides a gap."""
    m = cfg["model"]
    lm = m["lm"]
    ids = char_ids(instruction, lm["vocab_size"], m["max_text_len"])
    logits = lm_frame_logits(sd, Linears(sd, cfg.get("tier")), lm, img, n_frames, ids)
    return torch.sigmoid(logits.double()).cpu().numpy()


def with_highest_precision():
    """Float32 products in float32 (no TF32) for the rest of the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
