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


def ring_shard(q, k, v, kvalid, *, n: int, rank: int, start_fetch: Fetch,
               causal: bool = False, block_impl: str = "einsum"):
    """One rank's ring: q/k/v [B, H, s, D] and kvalid [B, s] (bool or uint8)
    are its shard.
    `start_fetch(i, blocks)` begins fetching the blocks of rank
    (rank + i + 1) % n while block i is computed and returns a callable
    that waits for them. Returns the shard's output [B, Hq, s, D]."""
    b, h, s_loc, d = q.shape
    sm_scale = d ** -0.5
    blocks = (k, v, kvalid)
    if block_impl == "flash":
        if causal:
            raise ValueError("flash-block ring supports the non-causal LM path")
        state = (torch.full((b, h, s_loc), NEG_BIG, device=q.device),
                 torch.zeros((b, h, s_loc, d), device=q.device))
    else:
        qpos = rank * s_loc + torch.arange(s_loc, device=q.device)
        state = (torch.full((b, h, s_loc), NEG_BIG, device=q.device),
                 torch.zeros((b, h, s_loc), device=q.device),
                 torch.zeros((b, h, s_loc, d), device=q.device))
    for i in range(n):
        wait = start_fetch(i, blocks) if i < n - 1 else None
        k_blk, v_blk, kv_blk = blocks
        kv_blk = kv_blk.bool()
        if block_impl == "flash":
            state = merge_flash(*state, *flash_block(q, k_blk, v_blk, kv_blk))
        else:
            src = (rank + i) % n
            kpos = src * s_loc + torch.arange(s_loc, device=q.device)
            kbias = torch.where(kv_blk, 0.0, NEG_BIG).float()
            state = merge_stats(*state, *block_stats(q, k_blk, v_blk, kbias, sm_scale, qpos,
                                                     kpos, causal), sm_scale)
        if wait is not None:
            blocks = wait()
    if block_impl == "flash":
        acc = state[1]
    else:
        _, l, acc = state
        acc = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return finish(acc, kvalid.bool(), q.dtype)


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
