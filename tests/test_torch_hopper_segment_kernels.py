"""The order of sums of kernels K and J's dK/dV, held to the JAX kernels.

Both run on the TMA + wgmma kernels of other callers with the segment-id mask
policy (csrc/hopper_attention.cuh): a key is seen iff it lies below S and its
int32 id equals the row's; every row is computed, whatever its id.

* K (`splash_mqa`) is kernel B's stream kernel on a pre-scaled q (sm_scale 1):
  keys in tiles of 128, a running max and sum, only a row that sees no key
  is 0 (`tiled_online(..., seen=segment_ids(...), sm_scale=1.0)` of
  tests/test_torch_hopper_attention.py; the kernel's per-tile id summary
  skips tests whose outcome it already knows, not sums). Held to the JAX package's
  `_splash_lm` and to jax's library splash kernel with three segments, in
  interpret mode, groups of 2, 7 and 8, fp32, at tests/test_torch_splash.py's
  tolerance (atol 2e-5, rtol 1e-4).
* J's dK/dV (`flash_segment_dkv`) is kernel E's key-stationary kernel with a
  group of 1 (`tiled_dkv(..., seen=segment_ids(...))` of
  tests/test_torch_hopper_train_attention.py): 128 keys a block, 64-row query
  tiles, under causal from the tile of the block's first key. Held to
  `jax.vjp` with respect to k and v of the `train-jax` arm (`mha`,
  `use_flash="train-jax"`) and of jax's library flash kernel with three
  segments and an id-0 tail, both under `pltpu.force_tpu_interpret_mode()`,
  fp32, at tests/test_torch_train_attention.py's tolerance for gradients (1e-3
  of the largest entry).

In bf16 both are held to the plain versions the card is checked against, at
chip_smoke.py's tolerance. The wrappers' device-independent checks run on CPU
and meta tensors.
"""

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
from test_torch_hopper_dq_attention import segment_ids
from test_torch_hopper_train_attention import _bf16_tol, _inputs, _rel, tiled_dkv
from videoitg_tpu.ops import attention as jax_attention
from videoitg_tpu_torch.ops import flash_attention_segment as fas
from videoitg_tpu_torch.ops import splash_attention as sa
from videoitg_tpu_torch.ops._kernel_args import check_layout

TOL = dict(atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------------ kernel K --

def _splash_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv))


def _port_splash(q, k, v, q_ids, kv_ids):
    """K's order on an already-scaled q."""
    return tiled_online(q, k, v, seen=segment_ids(q_ids, kv_ids), sm_scale=1.0)


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", [
    (2, 4, 2, 300, 16, (250, 280)),
    (2, 28, 4, 200, 16, (200, 77)),
    (1, 16, 2, 131, 72, (100,)),
], ids=["gqa4/2-s300", "gqa28/4-s200", "gqa16/2-s131-d72"])
def test_stream_order_with_segment_ids_matches_the_splash_arm(b, hq, hkv, s, d, lengths):
    """K as `splash_lm` calls it: q pre-scaled in its own dtype, ids = valid
    (0 / 1), invalid rows zeroed by the arm's final multiply, not the kernel."""
    q, k, v = _splash_inputs(hq + s, b, hq, hkv, s, d)
    valid = np.arange(s)[None] < np.asarray(lengths)[:, None]
    valid[:, 7] = False  # a hole in the first tile
    want = np.asarray(jax_attention._splash_lm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(valid), interpret=True))
    tq, tk, tv, tvalid = (torch.from_numpy(x) for x in (q, k, v, valid))
    ids = tvalid.to(torch.int32)
    out = _port_splash(sa.prescale(tq), tk, tv, ids, ids)
    # The kernel computes the id-0 rows (they attend the other id-0 keys).
    assert out.numpy()[:, :, ~valid[0]].any()
    got = (out * tvalid[:, None, :, None]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (16, 2)], ids=["group-2", "group-8"])
def test_stream_order_with_three_segments_matches_the_jax_splash_kernel(hq, hkv):
    """Ids other than 0 / 1 through jax's library splash kernel made by
    `_make_splash_kernel`, one (batch, KV head) at a time as `_splash_lm`
    vmaps it; S a multiple of its 128 block, so every row compares."""
    from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as sk

    s, d = 256, 16
    group = hq // hkv
    q, k, v = _splash_inputs(5, 1, hq, hkv, s, d)
    ids = np.array([-3, 5, 1000], np.int32)
    seg = ids[np.random.default_rng(6).integers(0, 3, s)]
    seg[:3] = ids
    kernel = jax_attention._make_splash_kernel(group, s, 128, True)
    sids = sk.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    want = np.stack([np.asarray(kernel(jnp.asarray(q[0].reshape(hkv, group, s, d)[h]),
                                       jnp.asarray(k[0, h]), jnp.asarray(v[0, h]),
                                       segment_ids=sids)) for h in range(hkv)])
    seg_t = torch.from_numpy(seg)[None]
    got = _port_splash(*(torch.from_numpy(x) for x in (q, k, v)), seg_t, seg_t).numpy()
    np.testing.assert_allclose(got[0], want.reshape(hq, s, d), **TOL)


def test_stream_order_with_segment_ids_matches_the_plain_version_in_bf16():
    """In the kernel's operand type, ids 0 / 1 straight into the kernel's
    contract (no final multiply), a query id no key has (its row is 0), a
    group of 7: K's order agrees with `splash_mqa_reference` within
    chip_smoke.py's tolerance."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _splash_inputs(9, 2, 14, 2, 300, 72))
    kv_ids = (torch.arange(300)[None] < torch.tensor([[260], [300]])).to(torch.int32)
    q_ids = kv_ids.clone()
    q_ids[1, 40:50] = 77
    qs = sa.prescale(q)
    ref = sa.splash_mqa_reference(qs, k, v, q_ids, kv_ids).float()
    got = _port_splash(qs, k, v, q_ids, kv_ids).to(torch.bfloat16).float()
    assert (got - ref).abs().max() <= _bf16_tol(ref)
    assert not got[1, :, 40:50].any()
    assert got[0, :, 260:].abs().max() > 0.1  # id-0 rows are computed, not zeroed


# --------------------------------------------------------------- J's dK/dV --

def _port_segment_dkv(q, k, v, do, q_ids, kv_ids, causal):
    """J's dK/dV order on MHA inputs, on the plain forward's o and lse."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tqi, tki = torch.from_numpy(q_ids), torch.from_numpy(kv_ids)
    o, lse = fas.flash_segment_fwd_reference(tq, tk, tv, tqi, tki, causal)
    delta = fas.segment_delta(o, tdo)
    dk, dv = tiled_dkv(tq, tk, tv, None, tdo, lse, delta, causal, seen=segment_ids(tqi, tki))
    return dk.numpy(), dv.numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 2, 300, 72), (1, 4, 4, 130, 16)])
def test_segment_dkv_order_matches_the_train_jax_arm(shape, causal):
    """J's dK/dV as the `train-jax` arm calls it: KV heads repeated (their
    gradients summed back over the group), S padded to 512 with zeros in
    segment 0, ids = valid; every key compared, the invalid ones too. Two
    batch rows of different valid lengths."""
    b, hq, hkv, s, d = shape
    q, k, v, do, valid = _inputs(31, b, hq, hkv, s, d, (s, s - 83)[:b])
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda k_, v_: jax_attention.mha(jnp.asarray(q), k_, v_, valid=jnp.asarray(valid),
                                             causal=causal, use_flash="train-jax"),
            jnp.asarray(k), jnp.asarray(v))
        want_dk, want_dv = (np.asarray(x) for x in vjp(jnp.asarray(do)))
    s_pad = -(-s // 512) * 512
    pad = [(0, 0), (0, 0), (0, s_pad - s), (0, 0)]
    group = hq // hkv
    qp, dop = np.pad(q, pad), np.pad(do, pad)
    kp, vp = (np.pad(np.repeat(x, group, axis=1), pad) for x in (k, v))
    ids = np.pad(valid.astype(np.int32), [(0, 0), (0, s_pad - s)])
    dk, dv = (x.reshape(b, hkv, group, s_pad, d).sum(2)[:, :, :s]
              for x in _port_segment_dkv(qp, kp, vp, dop, ids, ids, causal))
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert _rel(got, want) < 1e-3, (name, _rel(got, want))
    if not causal:  # invalid keys get gradients from the invalid rows and the padding
        assert np.abs(dv[:, :, ~valid[-1]]).max() > 1e-3


@pytest.mark.parametrize("causal", [False, True])
def test_segment_dkv_order_matches_jax_library_with_three_segments(causal):
    """Three segments (ids 7, -2, 9 in runs and scattered) and an id-0 tail of
    zero padding, through jax's library flash kernel directly (the kernel
    `mha_trainable` calls), D = 72: each key gets gradients from its own
    segment's rows only."""
    b, h, s, d = 1, 3, 512, 72
    rng = np.random.default_rng(32)
    q, k, v, do = (rng.standard_normal((b, h, s, d), dtype=np.float32) for _ in range(4))
    ids = np.zeros((b, s), np.int32)
    ids[:, :140], ids[:, 140:230], ids[:, 230:300] = 7, -2, 9
    ids[:, 20:300:9] = rng.choice([7, -2, 9], size=ids[:, 20:300:9].shape)
    for x in (q, k, v):
        x[:, :, 300:] = 0
    sizes = BlockSizes(block_q=512, block_k_major=512, block_k=512, block_b=1,
                       block_q_major_dkv=512, block_k_major_dkv=512, block_k_dkv=512,
                       block_q_dkv=512, block_k_major_dq=512, block_k_dq=512, block_q_dq=512)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda k_, v_: jax_library_flash(jnp.asarray(q), k_, v_, causal=causal,
                                             sm_scale=d ** -0.5,
                                             segment_ids=SegmentIds(q=jnp.asarray(ids),
                                                                    kv=jnp.asarray(ids)),
                                             block_sizes=sizes), jnp.asarray(k), jnp.asarray(v))
        want_dk, want_dv = (np.asarray(x) for x in vjp(jnp.asarray(do)))
    dk, dv = _port_segment_dkv(q, k, v, do, ids, ids, causal)
    for name, got, want in (("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert _rel(got, want) < 1e-3, (name, _rel(got, want))
    # ... and the order agrees with the plain version's dk, dv there.
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tids = torch.from_numpy(ids)
    o, lse = fas.flash_segment_fwd_reference(tq, tk, tv, tids, tids, causal)
    plain = fas.flash_segment_dkv(tq, tk, tv, tids, tids, tdo, lse, fas.segment_delta(o, tdo),
                                  causal)
    for got, ref in zip((dk, dv), plain):
        assert _rel(got, ref.numpy()) < 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_segment_dkv_order_matches_the_plain_backward_in_bf16(causal):
    """In the kernel's operand type J's dK/dV order agrees with
    `flash_mha_segment_backward_reference` (which rounds p and ds at the
    same points) within chip_smoke.py's tolerance: only the fp32 summation
    order and exp2 against exp differ."""
    q, k, v, do, valid = (torch.from_numpy(x) for x in _inputs(33, 2, 6, 6, 300, 72, (300, 170)))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    ids = valid.to(torch.int32) * torch.tensor([[3], [-5]], dtype=torch.int32)
    o, lse = fas.flash_segment_fwd_reference(q, k, v, ids, ids, causal)
    _, ref_dk, ref_dv = fas.flash_mha_segment_backward_reference(q, k, v, ids, ids, o, lse, do,
                                                                 causal)
    dk, dv = tiled_dkv(q, k, v, None, do, lse, fas.segment_delta(o, do), causal,
                       seen=segment_ids(ids, ids))
    for got, ref in ((dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.bfloat16
        assert (got.float() - ref.float()).abs().max() <= _bf16_tol(ref.float())


# ---------------------------------------------------------------- wrappers --

@pytest.mark.parametrize("name", ["splash_mqa", "flash_segment_dkv"])
def test_wrappers_refuse_misaligned_and_noncontiguous_operands(name):
    """K and J's dK/dV read q, k, v (and dO) through TMA tensor maps, which
    need contiguous, 16-byte-aligned bases: both are refused before any
    pointer reaches CUDA, as are tensors off the card on the kernel path."""
    base = torch.zeros(2 * 8 * 72 + 4, dtype=torch.bfloat16)
    shifted = base[4:4 + 2 * 8 * 72].view(1, 2, 8, 72)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_layout(name, shifted)
    strided = torch.zeros(1, 8, 2, 72, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        check_layout(name, strided)
    q = torch.empty(1, 2, 8, 72, dtype=torch.bfloat16, device="meta")
    ids = torch.empty(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if name == "splash_mqa":
            sa.splash_mqa(q, q, q, ids, ids)
        else:
            stat = torch.empty(1, 2, 8, device="meta")
            fas.flash_segment_dkv(q, q, q, ids, ids, q, stat, stat)


def test_splash_wrapper_refuses_shapes_beyond_the_grid():
    """The shapes K's kernel refuses, on meta tensors (no memory): B or Hq
    above 65535, B * S of 2^31 or more, Hq not a multiple of Hkv, k or v not
    beside q."""
    q = torch.empty(1, 16, 8, 8, device="meta")
    kv = torch.empty(1, 2, 8, 8, device="meta")
    assert sa.check_shapes(q, kv, kv) == (1, 16, 2, 8, 8)
    heads = torch.empty(1, 65536, 8, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        sa.check_shapes(heads, kv, kv)
    batch = torch.empty(65536, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        sa.check_shapes(batch, batch, batch)
    long_q = torch.empty(2, 1, 2 ** 30, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        sa.check_shapes(long_q, long_q, long_q)
    with pytest.raises(ValueError, match="multiple"):
        sa.check_shapes(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="do not match"):
        sa.check_shapes(q, kv[:, :, :4], kv[:, :, :4])
