"""The order of sums of the query-stationary dQ kernel, held to the JAX kernels.

Kernels D (`flash_train_dq`) and J's dQ (`flash_segment_dq`) are one kernel,
csrc/hopper_attention_dq.cuh, with two mask policies. A block owns 128 query
rows of one q head and walks the key tiles of 128 keys in order (under causal
up to the tile that holds the block's last row): p = exp2(s * scale log2 e -
lse log2 e), 0 where the policy hides the key or (causal) the key lies after
the row; ds = p (dp - delta); dQ += bf16(ds) K in fp32; dQ times sm_scale at
the end. `tiled_dq` writes that order out with either policy:

* `key_mask(valid)` (D): GQA, a key-valid mask; the caller zeroes dO on
  invalid query rows. Held to `jax.grad` (with respect to q) of
  videoitg_tpu.ops.flash_attention_train.flash_mha_train in interpret mode.
* `segment_ids(q_ids, kv_ids)` (J): MHA after the KV repeat, a key seen iff
  its id equals the row's. Held to the JAX package's `train-jax` arm
  (`mha`, `use_flash="train-jax"`) and to jax's library flash kernel that
  arm calls, with three segments and an id-0 tail, both under
  `pltpu.force_tpu_interpret_mode()`.

fp32 at tests/test_torch_train_attention.py's tolerance for gradients (1e-3
of the largest entry); in bf16 both policies are held to the plain versions
the card is checked against, at chip_smoke.py's tolerance. The wrappers'
device-independent checks of J run on CPU and meta tensors.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    BlockSizes,
    SegmentIds,
    flash_attention as jax_library_flash,
)

from test_torch_hopper_attention import tiled_online
from test_torch_hopper_train_attention import (
    CASES,
    _bf16_tol,
    _inputs,
    _jax_forward_and_grads,
    _rel,
)
from videoitg_tpu.ops import attention as jax_attention
from videoitg_tpu_torch.ops import flash_attention_segment as fas
from videoitg_tpu_torch.ops import flash_attention_train as fat
from videoitg_tpu_torch.ops._kernel_args import check_layout

ROWS = 128  # query rows per block (hattn::kBlockM)
KEYS = 128  # keys per ring stage (hattn::kDqKeys)
LOG2E = math.log2(math.e)


def key_mask(valid):
    """Kernel D's policy: [B, S] bool or None -> seen(rows, keys) [B, 1, R, K]."""
    def seen(rows, keys):
        b = 1 if valid is None else valid.shape[0]
        ok = torch.ones(b, 1, len(rows), len(keys), dtype=torch.bool)
        return ok if valid is None else ok & valid[:, None, None, keys]
    return seen


def segment_ids(q_ids, kv_ids):
    """Kernel J's policy: a key is seen iff its id equals the row's."""
    def seen(rows, keys):
        return (q_ids[:, rows, None] == kv_ids[:, None, keys])[:, None]
    return seen


def tiled_dq(q, k, v, do, lse, delta, seen, causal=False):
    """The dQ kernel's arithmetic on its own inputs: per block of 128 query
    rows, the key tiles of 128 in order (causal: up to the tile of the
    block's last row); p = exp2(s * scale log2 e - lse log2 e), 0 where
    `seen` hides the key or (causal) after the row; ds = p (dp - delta);
    dQ += bf16(ds) K in fp32; times sm_scale at the end. q head h reads KV
    head h // (Hq / Hkv)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    dt = q.dtype
    sl = d ** -0.5 * LOG2E
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    qf, dof = q.float(), do.float()
    lse2 = lse * LOG2E
    dq = torch.zeros(b, hq, s, d)
    for q0 in range(0, s, ROWS):
        rows = torch.arange(q0, min(q0 + ROWS, s))
        last = rows[-1].item() if causal else s - 1
        acc = torch.zeros(b, hq, len(rows), d)
        for k0 in range(0, last // KEYS * KEYS + 1, KEYS):
            keys = torch.arange(k0, min(k0 + KEYS, s))
            sc = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            dp = dof[:, :, rows] @ vf[:, :, keys].transpose(-1, -2)
            ok = seen(rows, keys)
            if causal:
                ok = ok & (keys[None, :] <= rows[:, None])
            p = torch.where(ok, torch.exp2(sc * sl - lse2[:, :, rows, None]), 0.0)
            ds = p * (dp - delta[:, :, rows, None])
            acc += ds.to(dt).float() @ kf[:, :, keys]
        dq[:, :, rows] = acc * d ** -0.5
    return dq.to(dt)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_key_mask_order_matches_jax_dq(case, causal):
    """Kernel D: GQA 6/2 at S = 300 (ragged against 128), two batch rows of
    different valid lengths with a hole, D = 72 and 16."""
    q, k, v, do, valid = _inputs(20, *CASES[case])
    _, (want_dq, _, _) = _jax_forward_and_grads(q, k, v, do, valid, causal)
    tq, tk, tv, tdo, tvalid = (torch.from_numpy(x) for x in (q, k, v, do, valid))
    o, lse = tiled_online(tq, tk, tv, tvalid, causal=causal, with_lse=True)
    do0, delta = fat.prepare_backward(tvalid, o, tdo)
    dq = tiled_dq(tq, tk, tv, do0, lse, delta, key_mask(tvalid), causal).numpy()
    assert _rel(dq, want_dq) < 1e-3, _rel(dq, want_dq)
    # Invalid query rows get exactly 0.
    dead = ~np.broadcast_to(valid[:, None, :, None], dq.shape)
    assert not dq[dead].any()


def _port_segment_dq(q, k, v, do, q_ids, kv_ids, causal):
    """The SegmentIds order on MHA inputs, on the plain forward's o and lse."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tqi, tki = torch.from_numpy(q_ids), torch.from_numpy(kv_ids)
    o, lse = fas.flash_segment_fwd_reference(tq, tk, tv, tqi, tki, causal)
    delta = fas.segment_delta(o, tdo)
    return tiled_dq(tq, tk, tv, tdo, lse, delta, segment_ids(tqi, tki), causal).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 2, 300, 72), (1, 4, 4, 130, 16)])
def test_segment_ids_order_matches_the_train_jax_arm(shape, causal):
    """Kernel J's dQ as the `train-jax` arm calls it: KV heads repeated, S
    padded to 512 with zeros in segment 0, ids = valid; every row compared,
    the invalid ones too. Two batch rows of different valid lengths."""
    b, hq, hkv, s, d = shape
    q, k, v, do, valid = _inputs(21, b, hq, hkv, s, d, (s, s - 83)[:b])
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q_: jax_attention.mha(q_, jnp.asarray(k), jnp.asarray(v),
                                         valid=jnp.asarray(valid), causal=causal,
                                         use_flash="train-jax"), jnp.asarray(q))
        (want_dq,) = vjp(jnp.asarray(do))
    s_pad = -(-s // 512) * 512
    pad = [(0, 0), (0, 0), (0, s_pad - s), (0, 0)]
    group = hq // hkv
    qp, dop = np.pad(q, pad), np.pad(do, pad)
    kp, vp = (np.pad(np.repeat(x, group, axis=1), pad) for x in (k, v))
    ids = np.pad(valid.astype(np.int32), [(0, 0), (0, s_pad - s)])
    dq = _port_segment_dq(qp, kp, vp, dop, ids, ids, causal)[:, :, :s]
    assert _rel(dq, np.asarray(want_dq)) < 1e-3, _rel(dq, np.asarray(want_dq))
    if not causal:  # invalid rows are computed (causal, the hole's row sees itself alone)
        assert np.abs(dq[:, :, ~valid[-1]]).max() > 1e-3


@pytest.mark.parametrize("causal", [False, True])
def test_segment_ids_order_matches_jax_library_with_three_segments(causal):
    """Three segments (ids 7, -2, 9 in runs and scattered) and an id-0 tail of
    zero padding, through jax's library flash kernel directly (the kernel
    `mha_trainable` calls), D = 72: each row attends its own segment only."""
    b, h, s, d = 1, 3, 512, 72
    rng = np.random.default_rng(22)
    q, k, v, do = (rng.standard_normal((b, h, s, d), dtype=np.float32) for _ in range(4))
    ids = np.zeros((b, s), np.int32)
    ids[:, :140], ids[:, 140:230], ids[:, 230:300] = 7, -2, 9
    ids[:, 300:] = 0
    ids[:, 20:300:9] = rng.choice([7, -2, 9], size=ids[:, 20:300:9].shape)
    for x in (q, k, v):
        x[:, :, 300:] = 0
    sizes = BlockSizes(block_q=512, block_k_major=512, block_k=512, block_b=1,
                       block_q_major_dkv=512, block_k_major_dkv=512, block_k_dkv=512,
                       block_q_dkv=512, block_k_major_dq=512, block_k_dq=512, block_q_dq=512)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q_: jax_library_flash(q_, jnp.asarray(k), jnp.asarray(v), causal=causal,
                                         sm_scale=d ** -0.5,
                                         segment_ids=SegmentIds(q=jnp.asarray(ids),
                                                                kv=jnp.asarray(ids)),
                                         block_sizes=sizes), jnp.asarray(q))
        (want_dq,) = vjp(jnp.asarray(do))
    dq = _port_segment_dq(q, k, v, do, ids, ids, causal)
    assert _rel(dq, np.asarray(want_dq)) < 1e-3, _rel(dq, np.asarray(want_dq))
    # ... and both policies' order agrees with the plain version's dq there.
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tids = torch.from_numpy(ids)
    o, lse = fas.flash_segment_fwd_reference(tq, tk, tv, tids, tids, causal)
    plain = fas.flash_segment_dq(tq, tk, tv, tids, tids, tdo, lse, fas.segment_delta(o, tdo),
                                 causal).numpy()
    assert _rel(dq, plain) < 1e-5


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("policy", ["key mask", "segment ids"])
def test_order_matches_plain_versions_in_bf16(policy, causal):
    """In the kernel's operand type the order agrees with the plain versions
    (which round ds at the same point) within chip_smoke.py's tolerance: only
    the fp32 summation order and exp2 against exp differ."""
    q, k, v, do, valid = (torch.from_numpy(x) for x in _inputs(23, *CASES["gqa-6-2-d72"]))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    if policy == "key mask":
        o, lse = fat.flash_mha_train_reference(q, k, v, valid, causal)
        do0, delta = fat.prepare_backward(valid, o, do)
        ref = fat.backward_on_kernel_inputs(q, k, v, valid, do0, lse, delta, causal)[0]
        got = tiled_dq(q, k, v, do0, lse, delta, key_mask(valid), causal)
    else:
        k, v = (x.repeat_interleave(3, dim=1) for x in (k, v))
        ids = valid.to(torch.int32) * torch.tensor([[3], [-5]], dtype=torch.int32)
        o, lse = fas.flash_segment_fwd_reference(q, k, v, ids, ids, causal)
        delta = fas.segment_delta(o, do)
        ref = fas.backward_on_kernel_inputs(q, k, v, ids, ids, do, lse, delta, causal)[0]
        got = tiled_dq(q, k, v, do, lse, delta, segment_ids(ids, ids), causal)
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref.float()).abs().max() <= _bf16_tol(ref.float())


def test_segment_dq_wrapper_refuses_misaligned_and_noncontiguous_operands():
    """J's dQ reads q, k, v and dO through TMA tensor maps, which need
    contiguous, 16-byte-aligned bases: both are refused before any pointer
    reaches CUDA, as are CPU tensors on the kernel path."""
    base = torch.zeros(2 * 8 * 72 + 4, dtype=torch.bfloat16)
    shifted = base[4:4 + 2 * 8 * 72].view(1, 2, 8, 72)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_layout("flash_segment_dq", shifted)
    strided = torch.zeros(1, 8, 2, 72, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        check_layout("flash_segment_dq", strided)
    q = torch.zeros(1, 2, 8, 72, dtype=torch.bfloat16)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fas._check("flash_segment_dq", q, q, q, ids, ids, extra=(q,))


def test_segment_wrappers_refuse_shapes_beyond_the_grid():
    """The shapes J's kernels refuse, on meta tensors (no memory): B * S of
    2^31 or more (dQ's tensor maps and the grid), B or H above 65535, k, v or
    dO not q's shape."""
    q = torch.empty(2, 3, 8, 8, device="meta")
    assert fas.check_shapes("flash_segment_dq", q, q, q, extra=(q,)) == (2, 3, 8, 8)
    long_q = torch.empty(2, 1, 2 ** 30, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        fas.check_shapes("flash_segment_dq", long_q, long_q, long_q, extra=(long_q,))
    fas.check_shapes("flash_segment_dq", long_q[:1], long_q[:1], long_q[:1])
    heads = torch.empty(1, 65536, 8, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        fas.check_shapes("flash_segment_fwd", heads, heads, heads)
    batch = torch.empty(65536, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        fas.check_shapes("flash_segment_dkv", batch, batch, batch)
    with pytest.raises(ValueError, match="does not match"):
        fas.check_shapes("flash_segment_dq", q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="dO"):
        fas.check_shapes("flash_segment_dq", q, q, q, extra=(q[:, :, :4],))
