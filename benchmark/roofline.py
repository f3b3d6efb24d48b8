"""Operations, bytes and the least time of the work, from shapes alone.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no sparsity,
at its 700 W limit): 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s of HBM.
A share of a roofline or of the peak is the least time of the work over the
time the device took; the counts come from the call or the request, never
from which kernel ran, so they read the same work whatever implements it.

Attention: 2 * pairs * query heads * (head_dim + value head_dim) operations
(Q K^T and P V), pairs = valid query rows x valid keys per batch element;
bytes: q, k, v read once and the output written once, v and the output at
the value head dimension. A linear: 2 * M * K * N.

The LM's part of a question is Qwen2's (`score_work`) unless the
configuration's architecture module (benchmark/reference/<name>.py) counts
its own: `request_work` takes that module's `score_work` where it has one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


def attention_work(b: int, hq: int, hkv: int, s: int, d: int,
                   pairs: Optional[Sequence[int]] = None, elt_bytes: int = 2,
                   dv: Optional[int] = None):
    """(operations, bytes) of one attention call q [b, hq, s, d], k [b, hkv,
    s, d], v [b, hkv, s, dv] (dv default d); `pairs` per batch element
    (default s * s)."""
    dv = d if dv is None else dv
    n_pairs = b * s * s if pairs is None else sum(pairs)
    ops = 2.0 * n_pairs * hq * (d + dv)
    nbytes = float(elt_bytes) * b * s * (hq + hkv) * (d + dv)  # q, k at d; v, out at dv
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time: the larger of operations over the peak and bytes over
    the bandwidth."""
    return max(ops / peak, nbytes / PEAK_BYTES)


def linear_ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


@dataclass
class Work:
    """Operations of one request by where they run, and the least time."""

    bf16_ops: float = 0.0
    int8_ops: float = 0.0
    attention_s: float = 0.0  # least time of its attention calls
    attention_ops: float = 0.0

    @property
    def ops(self) -> float:
        return self.bf16_ops + self.int8_ops + self.attention_ops

    @property
    def least_s(self) -> float:
        return self.bf16_ops / PEAK_BF16 + self.int8_ops / PEAK_INT8 + self.attention_s

    def add(self, other: "Work") -> "Work":
        return Work(self.bf16_ops + other.bf16_ops, self.int8_ops + other.int8_ops,
                    self.attention_s + other.attention_s,
                    self.attention_ops + other.attention_ops)


def tower_work(model: dict, tier: Optional[str], frames: int) -> Work:
    """Patch embedding, the encoder layers that run and their attention, for
    `frames` frames."""
    v = model["vision"]
    h, m = v["hidden_size"], v["intermediate_size"]
    grid = v["image_size"] // v["patch_size"]
    n = grid * grid
    sel = v["select_layer"]
    layers = v["num_layers"] + 1 + sel if sel < 0 else sel
    tokens = frames * n
    encoder = layers * (4 * linear_ops(tokens, h, h) + 2 * linear_ops(tokens, h, m))
    patch = linear_ops(tokens, v["patch_size"] ** 2 * 3, h)
    heads = v["num_heads"]
    ops, nbytes = attention_work(frames, heads, heads, n, h // heads)
    w = Work(bf16_ops=patch, attention_s=layers * bound_seconds(ops, nbytes),
             attention_ops=layers * ops)
    if tier == "act8":
        w.int8_ops = encoder
    else:
        w.bf16_ops += encoder
    return w


def score_work(model: dict, tier: Optional[str], frames: int, text_tokens: int) -> Work:
    """Projector, LM and head of one question on `frames` encoded frames
    with `text_tokens` valid instruction tokens: the valid tokens only."""
    v, p, lm = model["vision"], model["projector"], model["lm"]
    grid = v["image_size"] // v["patch_size"]
    hw = min(math.isqrt(p["vision_token_num"] // frames), grid)
    img = frames * hw * hw
    n = img + text_tokens
    h, mlp = lm["hidden_size"], lm["intermediate_size"]
    q_dim, kv_dim = lm["num_heads"] * lm["head_dim"], lm["num_kv_heads"] * lm["head_dim"]
    proj = linear_ops(img, p["input_dim"], p["output_dim"]) + linear_ops(img, p["output_dim"],
                                                                          p["output_dim"])
    layer = (linear_ops(n, h, q_dim) + 2 * linear_ops(n, h, kv_dim) + linear_ops(n, q_dim, h)
             + 2 * linear_ops(n, h, mlp) + linear_ops(n, mlp, h))
    ops, nbytes = attention_work(1, lm["num_heads"], lm["num_kv_heads"], n, lm["head_dim"])
    w = Work(bf16_ops=proj + linear_ops(frames, h, 1),
             attention_s=lm["num_layers"] * bound_seconds(ops, nbytes),
             attention_ops=lm["num_layers"] * ops)
    if tier == "act8":
        w.int8_ops = lm["num_layers"] * layer
    else:
        w.bf16_ops += lm["num_layers"] * layer
    return w


def request_work(model: dict, tier: Optional[str], frames: int, text_tokens: int,
                 with_tower: bool, arch=None) -> Work:
    """One question, and the tower where the request ran it; the question's
    part by `arch`'s `score_work` where the architecture module has one."""
    w = getattr(arch, "score_work", score_work)(model, tier, frames, text_tokens)
    return w.add(tower_work(model, tier, frames)) if with_tower else w
