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
  the replicated bias is added once, after the sum. Every sum over tp runs
  in fp32 over the partials as rounded to their dtype, then rounds once, as
  GSPMD's all-reduce of a bf16 partial product does on the JAX package's
  CPU mesh. Under the act8 tier the row's int8 scale comes from the amax of
  the WHOLE row (an all-reduce MAX over tp before quantising), as GSPMD makes
  the JAX package's amax global; kernel F takes that scale as given. A
  packed-int4 row-parallel weight holds this rank's input rows, repacked
  (parallel/sharding.py), so it takes the local features as they are.
* the vocab-sharded embedding: a masked local gather, then a sum over tp;
  exact, as one rank contributes each row.

LoRA leaves stay replicated: a column-parallel linear applies its adapter's
output columns, a row-parallel one its input rows: x @ a over the local rows
is summed over tp (rank r wide), then multiplied by b and the scale and added
to the summed product, as GSPMD orders it.

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
* a replicated LoRA leaf used on a slice (a, b and the scale of a
  column-parallel linear, a of a row-parallel one) gets a partial gradient
  on each rank: `copy_to_tp` on the leaf sums it over tp, so every rank
  holds the whole gradient;
* a gathered column-parallel output: all-gather forward, this rank's slice
  of the cotangent backward (`gather_from_tp`).

Without gradients the collectives run in place, as in serving.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _sum_over_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over tp in fp32 at least, in x's dtype: each rank's
    partial is rounded to its dtype once, the sum is not (as GSPMD sums a
    bf16 partial product: an fp32 all-reduce of the rounded partials)."""
    y = x.to(torch.promote_types(x.dtype, torch.float32), memory_format=torch.contiguous_format,
             copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_tp(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over_tp(x, group)

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
    """The sum of x over tp (`_sum_over_tp`); under autograd the cotangent
    passes unchanged."""
    if _grad(x):
        return _ReduceFromTP.apply(x, group)
    return _sum_over_tp(x, group)


def gather_from_tp(x: torch.Tensor, group, rank: int) -> torch.Tensor:
    """Every rank's x concatenated on the last axis; under autograd this
    rank's slice of the cotangent."""
    if _grad(x):
        return _GatherFromTP.apply(x, group, rank)
    from videoitg_tpu_torch.parallel.mesh import all_gather_cat

    return all_gather_cat(x, group, dim=-1)


def _lora(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor
          ) -> torch.Tensor:
    return _lora_tail(x.to(a.dtype) @ a, b, scale)


def _lora_tail(h: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The adapter's delta from h = x @ a."""
    return (h @ b) * scale.to(h.dtype)


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
        x = copy_to_tp(x, t.group)
        y = _product(p, x, act8)
        if p.lora_a is not None:
            # each rank's output columns: a, b's columns and the scale each get a
            # partial gradient, summed over tp
            a, b, scale = (copy_to_tp(leaf, t.group) for leaf in (p.lora_a, p.lora_b,
                                                                   p.lora_scale))
            y = y + _lora(x, a, b[:, _part(t, b.shape[1])], scale).to(y.dtype)
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
    y = reduce_from_tp(_product(p, x, act8, x_scale=x_scale), t.group)
    if p.lora_a is not None:
        # as GSPMD has it: x @ a over this rank's rows, summed over tp (r wide,
        # fp32), then @ b, added to the summed product as with no mesh. a's
        # rows get their gradient on one rank each (summed over tp); b and the
        # scale meet the whole sum, so every rank has their whole gradient.
        a = copy_to_tp(p.lora_a, t.group)
        h = reduce_from_tp(x.to(a.dtype) @ a[_part(t, a.shape[0])], t.group)
        y = y + _lora_tail(h, p.lora_b, p.lora_scale).to(y.dtype)
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
