"""Multi-head attention: the plain oracle and the kernel dispatch.

Counterpart of videoitg_tpu/ops/attention.py with one contract:
q [B, Hq, S, D], k/v [B, Hkv, S, D] with Hq a multiple of Hkv (the LM has
28 q / 4 kv heads), `valid` a [B, S] bool key mask, fp32 softmax whatever
the input dtype.

* `mha_reference` — plain PyTorch, O(S^2) memory. The numerics oracle.
* `mha` — dispatch: `use_flash=False` runs the oracle; `use_flash=True`
  runs the hand-written kernels (`flash_mha_short` for the vision tower's
  short unmasked MHA, `flash_mha` otherwise). Each kernel wrapper runs its
  own plain version when the tensors lie on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

SHORT_MAX_SEQ = 1024  # longest sequence the dispatch sends to the short kernel


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


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    causal: bool = False,
    use_flash: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Dispatch between the oracle and the kernels.

    The rule is the JAX package's: unmasked, non-causal MHA with S <= 1024
    and Hq == Hkv (the vision tower) takes the short kernel; everything else
    streams. The training, splash, ring and mesh arms of the JAX dispatch
    are not ported (ROADMAP queue 1).
    """
    if use_flash not in (False, True):
        raise NotImplementedError(
            f"use_flash={use_flash!r}: only the inference kernels are ported "
            "(training attention is in ROADMAP queue 1)")
    if sm_scale is not None and sm_scale == q.shape[-1] ** -0.5:
        sm_scale = None
    if not use_flash:
        return mha_reference(q, k, v, valid=valid, causal=causal, sm_scale=sm_scale)
    from videoitg_tpu_torch.ops.flash_attention import flash_mha
    from videoitg_tpu_torch.ops.flash_attention_short import flash_mha_short

    if (valid is None and not causal and q.shape[2] <= SHORT_MAX_SEQ
            and q.shape[1] == k.shape[1]):
        return flash_mha_short(q, k, v, sm_scale=sm_scale)
    if sm_scale is not None:
        raise ValueError("sm_scale override is for the short (vision) kernel only")
    return flash_mha(q, k, v, valid=valid, causal=causal)
