"""Tensor parallelism: the products of the linears that parallel/sharding.py
split over tp, with their collectives written out.

Where the JAX package lets GSPMD insert the collectives, each rank here runs
its slice and says what it needs:

* column-parallel (q/k/v, gate/up, the tower's fc1, the projector's fc1):
  the local output features, bias slice included; no communication. A
  column-parallel linear whose consumer reads every feature (the tower's
  patch embedding) gathers them over tp.
* row-parallel (o, down, the tower's fc2, the projector's fc2): the local
  input features give a partial product, summed over tp by one all-reduce;
  the replicated bias is added once, after the sum. Under the act8 tier the
  row's int8 scale comes from the amax of the WHOLE row (an all-reduce MAX
  over tp before quantising), as GSPMD makes the JAX package's amax global;
  kernel F takes that scale as given. A packed-int4 row-parallel weight
  holds this rank's input rows, repacked (parallel/sharding.py), so it
  takes the local features as they are.
* the vocab-sharded embedding: a masked local gather, then a sum over tp;
  exact, as one rank contributes each row.

LoRA leaves stay replicated: a column-parallel linear applies its adapter's
output columns, a row-parallel one its input rows (a partial delta, summed
with the product).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _lora(p, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    delta = (x.to(a.dtype) @ a) @ b
    return delta * p.lora_scale.to(delta.dtype)


def _part(t, n: int) -> slice:
    step = n // t.size
    return slice(t.rank * step, (t.rank + 1) * step)


def _product(p, x: torch.Tensor, act8, x_scale=None) -> torch.Tensor:
    """x @ w of the local slice, no bias."""
    from videoitg_tpu_torch.models.common import Linear

    if isinstance(p, Linear):
        return x @ p.w
    from videoitg_tpu_torch.ops.quant import Act8Switches, quantized_linear

    return quantized_linear(p, x, act8 if act8 is not None else Act8Switches(),
                            x_scale=x_scale, with_bias=False)


def _global_row_scale(x: torch.Tensor, group) -> torch.Tensor:
    """fp32 [M, 1] act8 row scales from the amax of the whole row."""
    from videoitg_tpu_torch.ops.quant import row_scale_of

    amax = x.reshape(-1, x.shape[-1]).float().abs().amax(dim=-1, keepdim=True)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return row_scale_of(amax)


def tp_linear(p, x: torch.Tensor, act8=None) -> torch.Tensor:
    """`models/common.linear` for a linear marked with a TPShard."""
    t = p.tp
    if t.kind in ("col", "col_gather"):
        y = _product(p, x, act8)
        if p.lora_a is not None:
            y = y + _lora(p, x, p.lora_a, p.lora_b[:, _part(t, p.lora_b.shape[1])]).to(y.dtype)
        if p.b is not None:
            y = y + p.b
        if t.kind == "col_gather":
            from videoitg_tpu_torch.parallel.mesh import all_gather_cat

            y = all_gather_cat(y, t.group, dim=-1)
        return y
    if t.kind != "row":
        raise ValueError(f"linear with tensor-parallel kind {t.kind!r}")
    x_scale = None
    if getattr(p, "act_q", False):
        x_scale = _global_row_scale(x, t.group)
    y = _product(p, x, act8, x_scale=x_scale)
    if p.lora_a is not None:
        a = p.lora_a[_part(t, p.lora_a.shape[0])]
        y = y + _lora(p, x, a, p.lora_b).to(y.dtype)
    dist.all_reduce(y, group=t.group)
    if p.b is not None:
        y = y + p.b
    return y


def vocab_embed(embed, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup over a vocab-sharded table: this rank's rows, zeros
    elsewhere, summed over tp."""
    t = embed.tp
    n = embed.w.shape[0]
    local = ids - t.rank * n
    hit = (local >= 0) & (local < n)
    out = embed.w[local.clamp(0, n - 1)] * hit[..., None].to(embed.w.dtype)
    dist.all_reduce(out, group=t.group)
    return out
