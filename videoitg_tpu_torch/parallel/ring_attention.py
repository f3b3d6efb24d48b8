"""Ring attention: exact attention with the sequence split over a mesh axis.

Counterpart of videoitg_tpu/parallel/ring_attention.py (`ring_attention`,
serving). Each rank of the sp ring holds one shard of the sequence: its
queries stay put while the key/value shards travel round the ring, one
`dist.batch_isend_irecv` a rotation (send to rank - 1, receive from
rank + 1, overlapped with the block in hand), n - 1 rotations for a ring of
n; the per-block softmax statistics merge exactly as flash attention's online
softmax does.

Two block forms, as in the JAX package:

* einsum blocks (`block_stats` + `merge_stats`): scores in the unscaled
  domain with an additive -1e30 key bias, causal or not; the plain path.
* flash blocks (`flash_block` + `merge_flash`): kernel C's forward
  (ops/flash_attention_train.flash_train_fwd, its key-mask-only form) on the
  visiting block, merged through the blocks' logsumexp. Non-causal (the
  grounding LM). A block with no valid key (lse = +inf from the kernel)
  counts as lse = -1e30, finite, so a row whose every block is dead merges
  to 0 and not to NaN.

Invalid query rows of the shard are zeroed at the end (`finish`). Activations
stay whole on every rank (the JAX package's island): `ring_attention` takes
global [B, H, S, D] tensors, runs this rank's shard and gathers the shards'
outputs over sp. `ring_shard` is one rank's ring given a way to fetch the
next blocks, so one process can drive every rank's steps (chip_smoke.py).

`ring_attention_train` (counterpart of the JAX `ring_attention_train`) is
differentiable: its forward is the flash-block ring, keeping only local
tensors (the q/k/v shard, the merged output and the global lse); its
backward is a second ring pass (`ring_shard_backward`): dO is zeroed on the
shard's invalid rows and delta reduced once (`prepare_backward`), then
kernel D (dQ) and kernel E (dK/dV) run once per visiting block with that
block's key mask and the global lse. The dK/dV accumulators are fp32 and
travel with their block; after n - 1 rotations one more brings them home.
The shards' gradients are gathered over sp, as the forward gathers its
output, so every sp rank holds the same activation gradient.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

NEG_BIG = -1e30


def block_stats(q, k, v, kbias, sm_scale: float, qpos, kpos, causal: bool):
    """One q shard x one kv block (GQA), fp32: (m, l, o_unnormalised), m in
    the unscaled-score domain."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    s = s + kbias[:, None, None, None, :]
    if causal:
        s = torch.where(kpos[None, None, None, None, :] <= qpos[None, None, None, :, None],
                        s, torch.full_like(s, NEG_BIG))
    m = s.amax(dim=-1)
    p = torch.exp((s - m[..., None]) * sm_scale)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return m.reshape(b, hq, sq), l.reshape(b, hq, sq), o.reshape(b, hq, sq, d)


def merge_stats(m, l, acc, m_blk, l_blk, o_blk, sm_scale: float):
    """Online-softmax merge of one einsum block into (m, l, acc)."""
    m_new = torch.maximum(m, m_blk)
    a_old = torch.exp((m - m_new) * sm_scale)
    a_blk = torch.exp((m_blk - m_new) * sm_scale)
    return (m_new, l * a_old + l_blk * a_blk,
            acc * a_old[..., None] + o_blk * a_blk[..., None])


def flash_block(q, k, v, kvalid):
    """Kernel C's forward on one visiting block, `kvalid` [B, s] its key
    mask: (lse, o fp32 normalised), lse = -1e30 where no key was valid."""
    from videoitg_tpu_torch.ops.flash_attention_train import flash_train_fwd

    o, lse = flash_train_fwd(q, k, v, valid=kvalid, causal=False, key_mask_only=True)
    lse = torch.where(torch.isinf(lse), torch.full_like(lse, NEG_BIG), lse)
    return lse, o.float()


def merge_flash(lse, acc, lse_blk, o_blk):
    """Merge one flash block into the running (lse, acc): acc stays the
    softmax-weighted average of the blocks seen, lse their logsumexp."""
    m_new = torch.maximum(lse, lse_blk)
    w_old = torch.exp(lse - m_new)
    w_blk = torch.exp(lse_blk - m_new)
    denom = w_old + w_blk
    acc = (acc * w_old[..., None] + o_blk * w_blk[..., None]) / denom[..., None]
    return m_new + torch.log(denom), acc


def finish(acc, qvalid, dtype):
    """Zero the shard's invalid query rows and cast to the model dtype."""
    return (acc * qvalid[:, None, :, None].to(acc.dtype)).to(dtype)


Fetch = Callable[[int, Sequence[torch.Tensor]], Callable[[], Sequence[torch.Tensor]]]


def ring_flash_state(q, k, v, kvalid, *, n: int, start_fetch: Fetch):
    """The flash-block ring of one rank: (lse, acc), acc the merged
    normalised output in fp32 (invalid query rows not yet zeroed) and lse
    the GLOBAL logsumexp of each row (-1e30 for a row with no valid key
    anywhere). Shared by serving and the training forward."""
    b, h, s_loc, d = q.shape
    state = (torch.full((b, h, s_loc), NEG_BIG, device=q.device),
             torch.zeros((b, h, s_loc, d), device=q.device))
    blocks = (k, v, kvalid)
    for i in range(n):
        wait = start_fetch(i, blocks) if i < n - 1 else None
        k_blk, v_blk, kv_blk = blocks
        state = merge_flash(*state, *flash_block(q, k_blk, v_blk, kv_blk.bool()))
        if wait is not None:
            blocks = wait()
    return state


def ring_shard(q, k, v, kvalid, *, n: int, rank: int, start_fetch: Fetch,
               causal: bool = False, block_impl: str = "einsum"):
    """One rank's ring: q/k/v [B, H, s, D] and kvalid [B, s] (bool or uint8)
    are its shard.
    `start_fetch(i, blocks)` begins fetching the blocks of rank
    (rank + i + 1) % n while block i is computed and returns a callable
    that waits for them. Returns the shard's output [B, Hq, s, D]."""
    b, h, s_loc, d = q.shape
    if block_impl == "flash":
        if causal:
            raise ValueError("flash-block ring supports the non-causal LM path")
        _, acc = ring_flash_state(q, k, v, kvalid, n=n, start_fetch=start_fetch)
        return finish(acc, kvalid.bool(), q.dtype)
    sm_scale = d ** -0.5
    blocks = (k, v, kvalid)
    qpos = rank * s_loc + torch.arange(s_loc, device=q.device)
    state = (torch.full((b, h, s_loc), NEG_BIG, device=q.device),
             torch.zeros((b, h, s_loc), device=q.device),
             torch.zeros((b, h, s_loc, d), device=q.device))
    for i in range(n):
        wait = start_fetch(i, blocks) if i < n - 1 else None
        k_blk, v_blk, kv_blk = blocks
        src = (rank + i) % n
        kpos = src * s_loc + torch.arange(s_loc, device=q.device)
        kbias = torch.where(kv_blk.bool(), 0.0, NEG_BIG).float()
        state = merge_stats(*state, *block_stats(q, k_blk, v_blk, kbias, sm_scale, qpos,
                                                 kpos, causal), sm_scale)
        if wait is not None:
            blocks = wait()
    _, l, acc = state
    acc = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return finish(acc, kvalid.bool(), q.dtype)


PassGrads = Callable[[torch.Tensor, torch.Tensor], Sequence[torch.Tensor]]


def ring_shard_backward(q, k, v, kvalid, o, lse, do, *, n: int, start_fetch: Fetch,
                        pass_grads: PassGrads):
    """One rank's backward ring, given its forward's local tensors: the shard
    q/k/v and kvalid, the shard's output o (invalid rows zero, model dtype),
    the global lse of `ring_flash_state` and the shard's dO. Returns
    (dq, dk, dv) of the shard.

    `start_fetch` fetches the visiting blocks as in `ring_shard`;
    `pass_grads(dk_acc, dv_acc)` sends the fp32 accumulators of the block
    in hand to rank - 1 and returns those of rank + 1's, which belong to the
    block fetched next. It is called n times: the n-th call brings every
    block's accumulators home."""
    from videoitg_tpu_torch.ops.flash_attention_train import (flash_train_dkv, flash_train_dq,
                                                              prepare_backward)

    do, delta = prepare_backward(kvalid.bool(), o, do)
    # A row with no valid key anywhere merged to lse = -1e30; the kernels'
    # dead-row convention is +inf (exp(s - lse) = 0), as in the JAX ring.
    lse = torch.where(lse <= NEG_BIG / 2, torch.full_like(lse, float("inf")), lse).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    blocks = (k, v, kvalid)
    for i in range(n):
        wait = start_fetch(i, blocks) if i < n - 1 else None
        k_blk, v_blk, kv_blk = blocks
        kv_blk = kv_blk.bool()
        dq += flash_train_dq(q, k_blk, v_blk, kv_blk, do, lse, delta).float()
        dk_i, dv_i = flash_train_dkv(q, k_blk, v_blk, kv_blk, do, lse, delta)
        dk_acc, dv_acc = pass_grads(dk_acc + dk_i.float(), dv_acc + dv_i.float())
        if wait is not None:
            blocks = wait()
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


def p2p_rotation(group, n: int, rank: int) -> Fetch:
    """`start_fetch` over a process group: each rotation sends the blocks in
    hand to rank - 1 and receives rank + 1's, in one batch_isend_irecv."""
    prev = dist.get_global_rank(group, (rank - 1) % n)
    nxt = dist.get_global_rank(group, (rank + 1) % n)

    def start(_i, blocks):
        sent = [b.contiguous() for b in blocks]
        recv = [torch.empty_like(b) for b in sent]
        ops = ([dist.P2POp(dist.isend, b, prev, group) for b in sent]
               + [dist.P2POp(dist.irecv, r, nxt, group) for r in recv])
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for req in reqs:
                req.wait()
            return recv
        return wait

    return start


def p2p_grad_rotation(group, n: int, rank: int) -> PassGrads:
    """`pass_grads` over a process group: the accumulators follow the
    blocks (to rank - 1, from rank + 1), in one batch_isend_irecv."""
    fetch = p2p_rotation(group, n, rank)
    return lambda dk_acc, dv_acc: fetch(0, (dk_acc, dv_acc))()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: Optional[torch.Tensor] = None, *, mesh, axis: str = "sp",
                   causal: bool = False, block_impl: str = "einsum") -> torch.Tensor:
    """Exact attention with the sequence split over `mesh[axis]`.

    q [B, Hq, S, D], k/v [B, Hkv, S, D] (GQA), whole on every rank, S a
    multiple of the ring's size; valid [B, S] bool masks keys, and invalid
    query rows output exact zeros (the flash-kernel contract). Returns the
    whole output, the same on every rank of the ring."""
    from videoitg_tpu_torch.parallel.mesh import all_gather_cat

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    rank = mesh.get_local_rank(axis)
    b, _, s, _ = q.shape
    if s % n:
        raise ValueError(f"seq {s} must divide the {axis}={n} ring")
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    part = slice(rank * s // n, (rank + 1) * s // n)
    # bool travels as uint8 (every backend carries bytes)
    shard = [x[:, :, part].contiguous() for x in (q, k, v)]
    kvalid = valid[:, part].contiguous().to(torch.uint8)
    out = ring_shard(*shard, kvalid, n=n, rank=rank, start_fetch=p2p_rotation(group, n, rank),
                     causal=causal, block_impl=block_impl)
    return all_gather_cat(out, group, dim=2)


def _shard_of(x: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    s = x.shape[2]
    return x[:, :, rank * s // n:(rank + 1) * s // n].contiguous()


class RingAttentionTrain(torch.autograd.Function):
    """Global q/k/v in, global output out (gathered over sp); see the module
    docstring. Saves the local tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, valid, group, n, rank):
        from videoitg_tpu_torch.parallel.mesh import all_gather_cat

        q_l, k_l, v_l = (_shard_of(x, n, rank) for x in (q, k, v))
        s = q.shape[2]
        # bool travels as uint8 (every backend carries bytes)
        kvalid = valid[:, rank * s // n:(rank + 1) * s // n].contiguous().to(torch.uint8)
        lse, acc = ring_flash_state(q_l, k_l, v_l, kvalid, n=n,
                                    start_fetch=p2p_rotation(group, n, rank))
        o_l = finish(acc, kvalid.bool(), q.dtype)
        ctx.save_for_backward(q_l, k_l, v_l, kvalid, o_l, lse)
        ctx.ring = (group, n, rank)
        return all_gather_cat(o_l, group, dim=2)

    @staticmethod
    def backward(ctx, do):
        from videoitg_tpu_torch.parallel.mesh import all_gather_cat

        group, n, rank = ctx.ring
        q_l, k_l, v_l, kvalid, o_l, lse = ctx.saved_tensors
        grads = ring_shard_backward(q_l, k_l, v_l, kvalid, o_l, lse, _shard_of(do, n, rank),
                                    n=n, start_fetch=p2p_rotation(group, n, rank),
                                    pass_grads=p2p_grad_rotation(group, n, rank))
        dq, dk, dv = (all_gather_cat(g, group, dim=2) for g in grads)
        return dq, dk, dv, None, None, None, None


def ring_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: Optional[torch.Tensor] = None, *, mesh,
                         axis: str = "sp") -> torch.Tensor:
    """Differentiable ring attention (non-causal, flash blocks): the
    contract of `ring_attention(block_impl="flash")`, with gradients to
    q/k/v from a second ring pass. On CUDA tensors every block runs kernels
    C, D and E; on CPU tensors their plain versions."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    rank = mesh.get_local_rank(axis)
    b, _, s, _ = q.shape
    if s % n:
        raise ValueError(f"seq {s} must divide the {axis}={n} ring")
    if valid is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    return RingAttentionTrain.apply(q, k, v, valid, group, n, rank)
