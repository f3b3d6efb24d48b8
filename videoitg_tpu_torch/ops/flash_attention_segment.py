"""Trainable MHA with a segment-id mask: CUDA kernels + plain versions.

Counterpart of the kernels behind `mha_trainable` in
videoitg_tpu/ops/attention.py (the `use_flash="train-jax"` arm): jax's
library flash attention for the TPU, forward, dq and dkv under one custom
VJP. The kernels here are launched from csrc/flash_attention_segment.cu,
hand-written for Hopper: the forward on mma.sync; dQ on the query-stationary
TMA + wgmma kernel of csrc/hopper_attention_dq.cuh that kernel D shares, and
dK/dV on the key-stationary TMA + wgmma kernel of
csrc/hopper_attention_dkv.cuh that kernel E shares, each with the segment-id
mask policy. The source notes give their design and how they differ from
csrc/flash_attention_train.cu. Three wrappers launch them, each with a
`.launches` count:

* `flash_segment_fwd`  -> (o, lse): online-softmax forward plus the per-row
  logsumexp (natural log, fp32) that the backward needs.
* `flash_segment_dq`   -> dq; no atomics, two runs give the same bits.
* `flash_segment_dkv`  -> (dk, dv); a block owns 128 keys of one head, so
  there are no atomics and two runs give the same bits.

`flash_mha_segment` ties them into a `torch.autograd.Function`.

Contract (shared with the plain versions): q, k, v [B, H, S, D] with as many
KV heads as query heads (a GQA caller repeats its KV heads first), `q_ids`
and `kv_ids` int32 [B, S]. A query attends a key iff their ids are equal
and, when `causal`, key index <= query index. The scores are scaled by
D ** -0.5 in fp32. Every row is computed, whatever its id: a caller that
gives padding the id 0 gets rows that attend all the other id-0 keys, with
gradients like any row. A query that sees no key at all (its id matches none
that the causal cut leaves) outputs 0, stores lse = +inf and has zero
gradient; jax's kernel masks with a large finite value and would give such a
row the mean of V. `mha_trainable` reaches neither: it passes one id array
for both sides, so a row always sees itself.

Rounding points, repeated by the plain versions: p is rounded to the operand
dtype before p v and p^T dO, ds before ds k and ds^T q; dq and dk are scaled
by D ** -0.5 once, after the sum; delta = rowsum(dO * o) is reduced in fp32
outside the kernels, as jax's library does.

CPU tensors run the plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops._kernel_args import check_matrix, check_operands, stream_handle

HEAD_CHUNK = 4  # heads per pass of the written-out plain versions: bounds their [S, S] scores


def segment_visible(q_ids: torch.Tensor, kv_ids: torch.Tensor, causal: bool) -> torch.Tensor:
    """[B, 1, S, S] bool: which keys each query row may see."""
    mask = (q_ids[:, :, None] == kv_ids[:, None, :])[:, None]
    if causal:
        s = q_ids.shape[1]
        mask = mask & torch.ones(s, s, dtype=torch.bool, device=q_ids.device).tril()
    return mask


def flash_mha_segment_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                q_ids: torch.Tensor, kv_ids: torch.Tensor,
                                causal: bool = False) -> torch.Tensor:
    """The function in plain differentiable PyTorch, O(S^2) memory: fp32
    scaled scores, keys of another segment (or of a causal row's future) at
    -inf, fp32 softmax, p in v's dtype into p v. A row that sees no key
    outputs 0. Returns [B, H, S, D] in q.dtype; autograd gives its gradient."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    scores = scores.masked_fill(~segment_visible(q_ids, kv_ids, causal), float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_segment_fwd_reference(q, k, v, q_ids, kv_ids,
                                causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version with its rounding points: (o
    [B, H, S, D] in q.dtype, lse [B, H, S] fp32), a few heads at a time."""
    scale = q.shape[-1] ** -0.5
    mask = segment_visible(q_ids, kv_ids, causal)
    outs, lses = [], []
    for h in range(0, q.shape[1], HEAD_CHUNK):
        qh, kh, vh = (x[:, h:h + HEAD_CHUNK].float() for x in (q, k, v))
        scores = (torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale).masked_fill_(
            ~mask, float("-inf"))
        m = scores.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(scores - m)
        del scores
        l = p.sum(dim=-1, keepdim=True)
        dead = l == 0.0
        acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vh)
        del p
        safe_l = torch.where(dead, 1.0, l)
        outs.append(torch.where(dead, torch.zeros_like(acc), acc / safe_l))
        lses.append(torch.where(dead, float("inf"), m + torch.log(safe_l))[..., 0])
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=1)


def segment_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * o) in fp32, [B, H, S]: the one reduction of the
    backward that runs outside the kernels."""
    return (do.float() * o.float()).sum(dim=-1)


def backward_on_kernel_inputs(q, k, v, q_ids, kv_ids, do, lse, delta, causal):
    """The two backward kernels' plain version on their own inputs (`lse` and
    `delta` given), a few heads at a time: (dq, dk, dv) in the operand dtype."""
    scale = q.shape[-1] ** -0.5
    dt = q.dtype
    mask = segment_visible(q_ids, kv_ids, causal)
    dqs, dks, dvs = [], [], []
    for h in range(0, q.shape[1], HEAD_CHUNK):
        qh, kh, vh, doh = (x[:, h:h + HEAD_CHUNK].float() for x in (q, k, v, do))
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        p = torch.exp(scores - lse[:, h:h + HEAD_CHUNK, :, None]).masked_fill_(~mask, 0.0)
        del scores
        dp = torch.einsum("bhqd,bhkd->bhqk", doh, vh)
        ds = (p * (dp - delta[:, h:h + HEAD_CHUNK, :, None])).to(dt).float()
        del dp
        p = p.to(dt).float()
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, doh))
        del p
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale)
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale)
        del ds
    return (torch.cat(dqs, dim=1).to(dt), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


def flash_mha_segment_backward_reference(q, k, v, q_ids, kv_ids, o, lse, do, causal=False):
    """The backward's plain version, written out with the kernels' rounding
    points (not left to autograd), on a saved forward (o, lse): (dq, dk, dv)."""
    do = do.contiguous()
    return backward_on_kernel_inputs(q, k, v, q_ids, kv_ids, do, lse, segment_delta(o, do),
                                     causal)


def check_shapes(name, q, k, v, extra=()):
    """Raise on what the kernels refuse beyond `check_operands`: k, v (and
    dO) not q's shape, and B or H above 65535 or B * S of 2^31 or more (the
    grid, and the tensor maps of dQ and dK/dV). Returns (B, H, S, D)."""
    b, h, s, d = q.shape
    for what, x in (("k", k), ("v", v), *(("dO", x) for x in extra)):
        if x.shape != q.shape:
            raise ValueError(f"{name}: {what} {tuple(x.shape)} does not match q "
                             f"{tuple(q.shape)} (MHA: repeat the KV heads of a GQA model first)")
    if b > 65535 or h > 65535 or b * s >= 2 ** 31:
        raise ValueError(f"{name}: q {tuple(q.shape)} is beyond the kernel's grid "
                         f"(B, H <= 65535, B * S < 2^31)")
    return b, h, s, d


def _check(name, q, k, v, q_ids, kv_ids, extra=()):
    check_operands(name, q, k, v, *extra)
    b, h, s, d = check_shapes(name, q, k, v, extra)
    check_matrix(name, "q_ids", q_ids, torch.int32, (b, s), q.device)
    check_matrix(name, "kv_ids", kv_ids, torch.int32, (b, s), q.device)
    return b, h, s, d


def _check_stats(name, q, lse, delta):
    b, h, s, _ = q.shape
    check_matrix(name, "lse", lse, torch.float32, (b, h, s), q.device)
    check_matrix(name, "delta", delta, torch.float32, (b, h, s), q.device)


def flash_segment_fwd(q, k, v, q_ids, kv_ids, causal=False):
    """Forward kernel: (o, lse). CPU tensors run `flash_segment_fwd_reference`."""
    if q.device.type == "cpu":
        return flash_segment_fwd_reference(q, k, v, q_ids, kv_ids, causal)
    b, h, s, d = _check("flash_segment_fwd", q, k, v, q_ids, kv_ids)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    err = _build.library().videoitg_flash_segment_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_ids.data_ptr(), kv_ids.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, s, d, int(causal), d ** -0.5, stream_handle(q))
    _build.check(err, "flash_segment_fwd")
    flash_segment_fwd.launches += 1
    return out, lse


def flash_segment_dq(q, k, v, q_ids, kv_ids, do, lse, delta, causal=False):
    """dQ kernel on its own inputs. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return backward_on_kernel_inputs(q, k, v, q_ids, kv_ids, do, lse, delta, causal)[0]
    b, h, s, d = _check("flash_segment_dq", q, k, v, q_ids, kv_ids, extra=(do,))
    _check_stats("flash_segment_dq", q, lse, delta)
    dq = torch.empty_like(q)
    err = _build.library().videoitg_flash_segment_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_ids.data_ptr(), kv_ids.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, s, d,
        int(causal), d ** -0.5, stream_handle(q))
    _build.check(err, "flash_segment_dq")
    flash_segment_dq.launches += 1
    return dq


def flash_segment_dkv(q, k, v, q_ids, kv_ids, do, lse, delta, causal=False):
    """dK/dV kernel on its own inputs, as `flash_segment_dq`: (dk, dv)."""
    if q.device.type == "cpu":
        return backward_on_kernel_inputs(q, k, v, q_ids, kv_ids, do, lse, delta, causal)[1:]
    b, h, s, d = _check("flash_segment_dkv", q, k, v, q_ids, kv_ids, extra=(do,))
    _check_stats("flash_segment_dkv", q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.library().videoitg_flash_segment_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_ids.data_ptr(), kv_ids.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, s, d, int(causal), d ** -0.5, stream_handle(q))
    _build.check(err, "flash_segment_dkv")
    flash_segment_dkv.launches += 1
    return dk, dv


flash_segment_fwd.launches = 0
flash_segment_dq.launches = 0
flash_segment_dkv.launches = 0


def flash_segment_bwd(q, k, v, q_ids, kv_ids, o, lse, do, causal=False):
    """(dq, dk, dv) from the saved forward. CPU tensors run
    `flash_mha_segment_backward_reference`; CUDA tensors reduce delta and
    launch the dQ and dK/dV kernels."""
    if q.device.type == "cpu":
        return flash_mha_segment_backward_reference(q, k, v, q_ids, kv_ids, o, lse, do, causal)
    do = do.contiguous()
    delta = segment_delta(o, do)
    dq = flash_segment_dq(q, k, v, q_ids, kv_ids, do, lse, delta, causal)
    dk, dv = flash_segment_dkv(q, k, v, q_ids, kv_ids, do, lse, delta, causal)
    return dq, dk, dv


class FlashMHASegment(torch.autograd.Function):
    """o = attention(q, k, v) with the kernels above as forward and backward.
    Saves q, k, v, the ids, o, lse; under `torch.no_grad()` only the forward
    runs and nothing is kept."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, causal):
        o, lse = flash_segment_fwd(q, k, v, q_ids, kv_ids, causal)
        ctx.save_for_backward(q, k, v, q_ids, kv_ids, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_ids, kv_ids, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_segment_bwd(q, k, v, q_ids, kv_ids, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_mha_segment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_ids: torch.Tensor, kv_ids: torch.Tensor,
                      causal: bool = False) -> torch.Tensor:
    """Differentiable segment-masked MHA. Returns [B, H, S, D] in q.dtype.
    The kernels take contiguous operands; a strided view is copied first."""
    return FlashMHASegment.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 q_ids.contiguous(), kv_ids.contiguous(), bool(causal))
