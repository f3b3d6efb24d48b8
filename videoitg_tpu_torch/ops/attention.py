"""Multi-head attention: the plain oracle and the kernel dispatch.

Counterpart of videoitg_tpu/ops/attention.py with one contract:
q [B, Hq, S, D], k/v [B, Hkv, S, D] with Hq a multiple of Hkv (the LM has
28 q / 4 kv heads), `valid` a [B, S] bool key mask, fp32 softmax whatever
the input dtype.

* `mha_reference` — plain PyTorch, O(S^2) memory. The numerics oracle.
* `mha` — dispatch: `use_flash=False` runs the oracle; `use_flash=True`
  runs the hand-written inference kernels, which have no backward:
  `flash_mha_short` for the vision tower's short unmasked MHA, `flash_mha`
  otherwise, or, with the LM splash switch on, `splash_lm`
  (`ops/splash_attention.py`) for non-causal attention with a key mask, the
  LM's serving prefill; `use_flash="train"` runs the differentiable
  native-GQA kernels (`ops/flash_attention_train.flash_mha_train`);
  `use_flash="train-jax"` runs `mha_trainable`. Each kernel wrapper runs its
  own plain version when the tensors lie on the CPU.
* `mha_trainable` — the JAX package's A/B arm over a library kernel, under
  its JAX name: repeated KV heads, padding to a multiple of 512, segment
  ids, the differentiable segment-id kernels
  (`ops/flash_attention_segment.flash_mha_segment`).

The LM splash switch is the JAX package's A/B arm: `lm_splash=True / False`
decides it, `None` reads `VIDEOITG_LM_SPLASH` (`1` is on; off by default), so
one process can run both arms.

Under a device mesh (parallel/context.attention_mesh) the tensors are this
rank's: its batch share (dp) and its heads (tp), so the kernels run on them
as they are, with no communication. When the mesh carries an sp axis, a
masked sequence that splits over it (the LM's; the tower passes no mask)
runs as ring attention (parallel/ring_attention.py). Training, as the JAX
package's rule: `use_flash="train"` rings through `ring_attention_train`
(kernels C, D, E per block) when the call is not causal; causal calls and
`"train-jax"` keep their local heads on the whole sequence, and so does a
call that needs gradients under any other `use_flash` (the serving ring has
no backward; activations are whole on every rank). Serving: flash blocks
(kernel C's forward) with `use_flash` and not causal, einsum blocks
otherwise.
"""

from __future__ import annotations

from typing import Optional

import os

import torch
from torch.nn import functional as F

from videoitg_tpu_torch.utils import profiling

SHORT_MAX_SEQ = 1024  # longest sequence the dispatch sends to the short kernel
TRAINABLE_BLOCK = 512  # `mha_trainable` pads the sequence to a multiple of this


def resolve_lm_splash(lm_splash: Optional[bool] = None) -> bool:
    """The LM splash switch: an explicit value wins, None reads
    VIDEOITG_LM_SPLASH (`1` is on)."""
    if lm_splash is None:
        return os.environ.get("VIDEOITG_LM_SPLASH") == "1"
    return bool(lm_splash)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with an fp32 softmax.

    Rows with no valid key output zeros (not NaN). Query rows at invalid
    positions are computed like any other row; callers mask them downstream.
    Returns [B, Hq, S, D] in q.dtype.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    group = hq // hkv
    scale = d ** -0.5 if sm_scale is None else sm_scale

    qf = q.reshape(b, hkv, group, s, d).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if valid is not None:
        logits = logits.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    if causal:
        future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(future, float("-inf"))

    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, torch.ones_like(denom), denom)

    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


def mha_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Differentiable attention as the JAX package's `mha_trainable` computes
    it (the `"train-jax"` A/B arm), invalid rows and padding included.

    KV heads are repeated to the query heads (autograd sums their gradient
    back over the group); q, k, v are zero-padded to the next multiple of
    512; segment ids are `valid` as int32 (all ones without it) with the
    padding in segment 0; a query attends the keys of its own segment. So an
    invalid query row is NOT zero: it attends the other invalid keys and,
    when not causal, the zero padding. The output is cut back to S.
    """
    from videoitg_tpu_torch.ops.flash_attention_segment import flash_mha_segment

    b, hq, s, _ = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        if hq % hkv:
            raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    pad = -(-s // TRAINABLE_BLOCK) * TRAINABLE_BLOCK - s
    if valid is None:
        seg = torch.ones((b, s), dtype=torch.int32, device=q.device)
    else:
        seg = valid.to(torch.int32)
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        seg = F.pad(seg, (0, pad))  # padding -> segment 0
    out = flash_mha_segment(q, k, v, seg, seg, causal=causal)
    return out[:, :, :s]


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    use_flash=False,
    sm_scale: Optional[float] = None,
    lm_splash: Optional[bool] = None,
) -> torch.Tensor:
    """Dispatch between the oracle and the kernels.

    use_flash: False -> the plain oracle; True -> the inference kernels (no
    backward): unmasked, non-causal MHA with S <= 1024 and Hq == Hkv (the
    vision tower) takes the short kernel; non-causal attention with a key
    mask takes the splash arm when `lm_splash` is on (None reads
    VIDEOITG_LM_SPLASH); everything else streams; "train" -> the
    differentiable native-GQA kernels; "train-jax" -> `mha_trainable` (the
    A/B arm). Neither training arm takes an `sm_scale` override (a
    serving-path knob, as in the JAX package). Traced, the call is an
    `attention` span.
    """
    if profiling.tracing:
        with profiling.span("attention"):
            return _mha(q, k, v, valid, causal, use_flash, sm_scale, lm_splash)
    return _mha(q, k, v, valid, causal, use_flash, sm_scale, lm_splash)


def _mha(q, k, v, valid, causal, use_flash, sm_scale, lm_splash) -> torch.Tensor:
    if sm_scale is not None and sm_scale == q.shape[-1] ** -0.5:
        sm_scale = None
    if isinstance(use_flash, str):
        if use_flash not in ("train", "train-jax"):
            raise ValueError(f"unknown use_flash {use_flash!r}")
        if sm_scale is not None:
            raise ValueError("sm_scale override is a serving-path knob; the training "
                             "kernels use head_dim ** -0.5")
    from videoitg_tpu_torch.parallel.context import current_attention_mesh

    ctx = current_attention_mesh()
    ring = None
    if ctx is not None and ctx[3] is not None and valid is not None:
        from videoitg_tpu_torch.parallel.mesh import axis_size

        mesh, _dp, _tp, sp = ctx
        if q.shape[2] % axis_size(mesh, sp) == 0:
            ring = (mesh, sp)
    if ring is not None and not causal and use_flash == "train":
        from videoitg_tpu_torch.parallel.ring_attention import ring_attention_train

        return ring_attention_train(q.contiguous(), k.contiguous(), v.contiguous(),
                                    valid=valid, mesh=ring[0], axis=ring[1])
    if use_flash == "train-jax":
        return mha_trainable(q, k, v, valid=valid, causal=causal)
    if use_flash == "train":
        from videoitg_tpu_torch.ops.flash_attention_train import flash_mha_train

        return flash_mha_train(q, k, v, valid=valid, causal=causal)
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if ring is not None and not needs_grad:
        from videoitg_tpu_torch.parallel.ring_attention import ring_attention

        impl = "flash" if (use_flash and not causal) else "einsum"
        return ring_attention(q, k, v, valid=valid, mesh=ring[0], axis=ring[1],
                              causal=causal, block_impl=impl)
    if not use_flash:
        return mha_reference(q, k, v, valid=valid, causal=causal, sm_scale=sm_scale)
    from videoitg_tpu_torch.ops.flash_attention import flash_mha
    from videoitg_tpu_torch.ops.flash_attention_short import flash_mha_short

    if (valid is None and not causal and q.shape[2] <= SHORT_MAX_SEQ
            and q.shape[1] == k.shape[1]):
        return flash_mha_short(q, k, v, sm_scale=sm_scale)
    if sm_scale is not None:
        raise ValueError("sm_scale override is for the short (vision) kernel only")
    if not causal and valid is not None and resolve_lm_splash(lm_splash):
        from videoitg_tpu_torch.ops.splash_attention import splash_lm

        return splash_lm(q, k, v, valid)
    return flash_mha(q, k, v, valid=valid, causal=causal)
