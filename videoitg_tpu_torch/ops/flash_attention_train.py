"""Trainable streaming attention with native GQA: CUDA kernels + plain versions.

Counterpart of videoitg_tpu/ops/flash_attention_train.py (`flash_mha_train`,
Pallas `_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`). The kernels are
hand-written for Hopper and launched from csrc/flash_attention_train.cu: the
forward on the TMA + wgmma kernel of csrc/hopper_attention.cuh with the lse
store, dK/dV on the key-stationary TMA + wgmma kernel of
csrc/hopper_attention_dkv.cuh, dQ on the query-stationary TMA + wgmma kernel
of csrc/hopper_attention_dq.cuh with the key-mask policy; the source notes
give their design. Three wrappers launch them, each with a `.launches`
count:

* `flash_train_fwd`  -> (o, lse): online-softmax forward plus the per-row
  logsumexp (natural log, fp32) that the backward needs.
* `flash_train_dq`   -> dq; no atomics, two runs give the same bits.
* `flash_train_dkv`  -> (dk, dv), summed over the GQA group inside the kernel
  with no atomics, so two runs give the same bits.

`flash_mha_train` ties them into a `torch.autograd.Function`.

Contract (shared with the plain versions): q [B, Hq, S, D], k/v [B, Hkv, S, D]
with query head h reading KV head h // (Hq / Hkv), `valid` [B, S] bool or
None. A masked key has probability exactly 0 and gets dk = dv = 0. An invalid
query row outputs exact 0, its dO is ignored, and it gets dq = 0. A row with no
visible valid key outputs 0, stores lse = +inf and has zero gradient.
Rounding points, repeated by the plain versions: p is rounded to the operand
dtype before p v and p^T dO, ds before ds k and ds^T q; dq and dk are scaled
by sm_scale once, after the sum.

CPU tensors run the plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videoitg_tpu_torch.ops import _build, flash_attention
from videoitg_tpu_torch.ops._kernel_args import check_matrix, check_operands, stream_handle


def _visible(valid: Optional[torch.Tensor], causal: bool, b: int, s: int,
             device) -> Optional[torch.Tensor]:
    """[B, 1, S, S] bool (or None): which keys each query row may see."""
    mask = None
    if valid is not None:
        mask = valid[:, None, None, :].expand(b, 1, s, s)
    if causal:
        past = torch.ones(s, s, dtype=torch.bool, device=device).tril()[None, None]
        mask = past if mask is None else mask & past
    return mask


def flash_mha_train_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    key_mask_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version: (o [B, Hq, S, D] in q.dtype,
    lse [B, Hq, S] fp32). One query head of each group at a time, so that a
    long sequence holds [B, Hkv, S, S] scores and no more. `key_mask_only`
    keeps the invalid query rows as computed (the ring form)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = d ** -0.5
    mask = _visible(valid, causal, b, s, q.device)
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for g in range(group):
        qg = q[:, g::group].float()  # head hk * group + g of every KV head hk
        scores = torch.einsum("bhqd,bhkd->bhqk", qg, kf) * scale
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        m = scores.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(scores - m)
        l = p.sum(dim=-1, keepdim=True)
        dead = l == 0.0
        acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf)
        safe_l = torch.where(dead, 1.0, l)
        outs.append(torch.where(dead, torch.zeros_like(acc), acc / safe_l))
        lses.append(torch.where(dead, float("inf"), m + torch.log(safe_l))[..., 0])
    # [group, B, Hkv, ...] -> [B, Hkv, group, ...] -> [B, Hq, ...]
    o = torch.stack(outs, dim=2).reshape(b, hq, s, d)
    lse = torch.stack(lses, dim=2).reshape(b, hq, s)
    if valid is not None and not key_mask_only:
        o = o * valid[:, None, :, None].to(o.dtype)
    return o.to(q.dtype), lse


def backward_on_kernel_inputs(q, k, v, valid, do, lse, delta, causal):
    """The two backward kernels' plain version on their own inputs: `valid`
    masks keys only, `do` is already zero on invalid query rows, `delta` is
    given. Returns (dq, dk, dv) in the operand dtypes."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = d ** -0.5
    dt = q.dtype
    mask = _visible(valid, causal, b, s, q.device)
    kf, vf = k.float(), v.float()
    dqs = []
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for g in range(group):
        qg, dog = q[:, g::group].float(), do[:, g::group].float()
        scores = torch.einsum("bhqd,bhkd->bhqk", qg, kf) * scale
        p = torch.exp(scores - lse[:, g::group, :, None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", dog, vf)
        ds = (p * (dp - delta[:, g::group, :, None])).to(dt).float()
        p = p.to(dt).float()
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dog)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qg)
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale)
    dq = torch.stack(dqs, dim=2).reshape(b, hq, s, d)
    return dq.to(dt), (dk * scale).to(k.dtype), dv.to(v.dtype)


def prepare_backward(valid, o, do):
    """dO with invalid query rows zeroed, and delta = rowsum(dO * o) in fp32."""
    if valid is not None:
        do = do * valid[:, None, :, None].to(do.dtype)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1)
    return do, delta


def flash_mha_train_backward_reference(q, k, v, valid, o, lse, do, causal=False):
    """The backward's plain version, written out with the kernels' rounding
    points (not left to autograd): (dq, dk, dv)."""
    do, delta = prepare_backward(valid, o, do)
    return backward_on_kernel_inputs(q, k, v, valid, do, lse, delta, causal)


def check_shapes(name, q, k, v, valid, extra=()):
    """Raise on what the kernels refuse beyond `check_operands`: what
    `flash_attention.check_shapes` refuses (the forward is kernel B's kernel),
    and a dO that is not q's shape."""
    flash_attention.check_shapes(q, k, v, valid, name=name)
    for x in extra:
        if x.shape != q.shape:
            raise ValueError(f"{name}: dO {tuple(x.shape)} does not match q {tuple(q.shape)}")


def _check(name, q, k, v, valid, extra=()):
    check_operands(name, q, k, v, *extra)
    check_shapes(name, q, k, v, valid, extra)
    b, hq, s, d = q.shape
    return b, hq, k.shape[1], s, d


def _check_stats(name, q, lse, delta):
    b, hq, s, _ = q.shape
    check_matrix(name, "lse", lse, torch.float32, (b, hq, s), q.device)
    check_matrix(name, "delta", delta, torch.float32, (b, hq, s), q.device)


def flash_train_fwd(q, k, v, valid=None, causal=False, key_mask_only=False):
    """Forward kernel: (o, lse). CPU tensors run `flash_mha_train_reference`.

    `key_mask_only` is the ring form (parallel/ring_attention.py), non-causal:
    `valid` masks the keys of a visiting block only and every query row is
    stored as computed, lse included."""
    if q.device.type == "cpu":
        return flash_mha_train_reference(q, k, v, valid=valid, causal=causal,
                                         key_mask_only=key_mask_only)
    b, hq, hkv, s, d = _check("flash_train_fwd", q, k, v, valid)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), device=q.device, dtype=torch.float32)
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if valid is None else valid.data_ptr(), out.data_ptr(), lse.data_ptr())
    if key_mask_only:
        if causal:
            raise ValueError("flash_train_fwd: the key-mask-only form is non-causal")
        err = lib.videoitg_flash_train_fwd_keys_bf16(*ptrs, b, hq, hkv, s, d, d ** -0.5,
                                                     stream_handle(q))
    else:
        err = lib.videoitg_flash_train_fwd_bf16(*ptrs, b, hq, hkv, s, d, int(causal),
                                                d ** -0.5, stream_handle(q))
    _build.check(err, "flash_train_fwd")
    flash_train_fwd.launches += 1
    return out, lse


def flash_train_dq(q, k, v, valid, do, lse, delta, causal=False):
    """dQ kernel on its own inputs (`valid` masks keys; `do` already zero on
    invalid query rows). CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return backward_on_kernel_inputs(q, k, v, valid, do, lse, delta, causal)[0]
    b, hq, hkv, s, d = _check("flash_train_dq", q, k, v, valid, extra=(do,))
    _check_stats("flash_train_dq", q, lse, delta)
    dq = torch.empty_like(q)
    err = _build.library().videoitg_flash_train_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, hq, hkv, s, d, int(causal), d ** -0.5,
        stream_handle(q))
    _build.check(err, "flash_train_dq")
    flash_train_dq.launches += 1
    return dq


def flash_train_dkv(q, k, v, valid, do, lse, delta, causal=False):
    """dK/dV kernel on its own inputs, as `flash_train_dq`: (dk, dv)."""
    if q.device.type == "cpu":
        return backward_on_kernel_inputs(q, k, v, valid, do, lse, delta, causal)[1:]
    b, hq, hkv, s, d = _check("flash_train_dkv", q, k, v, valid, extra=(do,))
    _check_stats("flash_train_dkv", q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.library().videoitg_flash_train_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if valid is None else valid.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, s, d, int(causal),
        d ** -0.5, stream_handle(q))
    _build.check(err, "flash_train_dkv")
    flash_train_dkv.launches += 1
    return dk, dv


flash_train_fwd.launches = 0
flash_train_dq.launches = 0
flash_train_dkv.launches = 0


def flash_train_bwd(q, k, v, valid, o, lse, do, causal=False):
    """(dq, dk, dv) from the saved forward. CPU tensors run
    `flash_mha_train_backward_reference`; CUDA tensors zero dO on invalid
    query rows, reduce delta, and launch the dQ and dK/dV kernels."""
    if q.device.type == "cpu":
        return flash_mha_train_backward_reference(q, k, v, valid, o, lse, do, causal)
    do, delta = prepare_backward(valid, o, do)
    dq = flash_train_dq(q, k, v, valid, do, lse, delta, causal)
    dk, dv = flash_train_dkv(q, k, v, valid, do, lse, delta, causal)
    return dq, dk, dv


class FlashMHATrain(torch.autograd.Function):
    """o = attention(q, k, v) with the kernels above as forward and backward.
    Saves q, k, v, valid, o, lse; under `torch.no_grad()` only the forward
    runs and nothing is kept."""

    @staticmethod
    def forward(ctx, q, k, v, valid, causal):
        o, lse = flash_train_fwd(q, k, v, valid, causal)
        ctx.save_for_backward(q, k, v, valid, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_train_bwd(q, k, v, valid, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None


def flash_mha_train(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Differentiable streaming attention, native GQA. Returns [B, Hq, S, D]
    in q.dtype. The kernels take contiguous operands; a strided view (heads
    transposed out of a projection) is copied first."""
    return FlashMHATrain.apply(q.contiguous(), k.contiguous(), v.contiguous(), valid,
                               bool(causal))
