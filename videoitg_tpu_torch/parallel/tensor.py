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

Under autograd each collective has its backward written out (the JAX
package has GSPMD transpose them):

* the input of a column-parallel product (and of the tied LM head) is
  replicated while each rank's dX is partial: identity forward, all-reduce
  backward (`copy_to_tp`);
* the row-parallel sum and the embedding's sum: all-reduce forward,
  IDENTITY backward (`reduce_from_tp`). Every tp rank computes the same
  loss downstream, so its cotangent is already whole; the backward of
  `torch.distributed.nn.functional.all_reduce` would sum it again and give
  tp times the gradient;
* a replicated LoRA leaf used on a slice gets a partial gradient on each
  rank: `copy_to_tp` on the leaf sums it over tp, so every rank holds the
  whole gradient;
* a gathered column-parallel output: all-gather forward, this rank's slice
  of the cotangent backward (`gather_from_tp`).

Without gradients the collectives run in place, as in serving.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        from videoitg_tpu_torch.parallel.mesh import all_gather_cat

        ctx.part = (rank, x.shape[-1])
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        rank, n = ctx.part
        return g[..., rank * n:(rank + 1) * n], None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; under autograd its gradient is summed over tp."""
    return _CopyToTP.apply(x, group) if _grad(x) else x


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over tp; under autograd the cotangent passes unchanged."""
    if _grad(x):
        return _ReduceFromTP.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def gather_from_tp(x: torch.Tensor, group, rank: int) -> torch.Tensor:
    """Every rank's x concatenated on the last axis; under autograd this
    rank's slice of the cotangent."""
    if _grad(x):
        return _GatherFromTP.apply(x, group, rank)
    from videoitg_tpu_torch.parallel.mesh import all_gather_cat

    return all_gather_cat(x, group, dim=-1)


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
    lora_a = lora_b = None
    if p.lora_a is not None:
        lora_a, lora_b = copy_to_tp(p.lora_a, t.group), copy_to_tp(p.lora_b, t.group)
    if t.kind in ("col", "col_gather"):
        x = copy_to_tp(x, t.group)
        y = _product(p, x, act8)
        if lora_a is not None:
            y = y + _lora(p, x, lora_a, lora_b[:, _part(t, lora_b.shape[1])]).to(y.dtype)
        if p.b is not None:
            y = y + p.b
        if t.kind == "col_gather":
            y = gather_from_tp(y, t.group, t.rank)
        return y
    if t.kind != "row":
        raise ValueError(f"linear with tensor-parallel kind {t.kind!r}")
    x_scale = None
    if getattr(p, "act_q", False):
        x_scale = _global_row_scale(x, t.group)
    y = _product(p, x, act8, x_scale=x_scale)
    if lora_a is not None:
        y = y + _lora(p, x, lora_a[_part(t, lora_a.shape[0])], lora_b).to(y.dtype)
    y = reduce_from_tp(y, t.group)
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
    return reduce_from_tp(out, t.group)


def sharded_logits(t, hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits over the whole vocabulary from this rank's vocab columns
    `w` [H, V/tp] (the tied embedding's rows, transposed, or a
    column-parallel lm_head), gathered over tp."""
    h = copy_to_tp(hidden, t.group)
    return gather_from_tp(h.float() @ w.float(), t.group, t.rank)
