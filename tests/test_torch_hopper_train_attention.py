"""The order of sums of the training kernels C and E, held to the JAX kernels.

Kernel C (`flash_train_fwd`) is kernel B's TMA + wgmma kernel with the lse
store: keys in tiles of 128, a running max and sum, lse = (max * scale +
log2 sum) * ln 2 (`tiled_online(..., with_lse=True)` of
tests/test_torch_hopper_attention.py). Kernel E (`flash_train_dkv`,
csrc/hopper_attention_dkv.cuh) owns 128 keys of a KV head and walks the
group's q heads in order, each in query tiles of 64, with fp32 sums and P^T,
dS^T rounded to the operand type before they multiply dO and Q
(`tiled_dkv`). Both orders are written out here and held to the Pallas
kernels of videoitg_tpu/ops/flash_attention_train.py in interpret mode
(output and lse of `_fwd`, `jax.grad` of `flash_mha_train`), fp32, at
tests/test_torch_train_attention.py's tolerances: values atol 2e-5 / rtol
1e-4, gradients 1e-3 of the largest entry. In bf16 they are held to the
plain versions the card is checked against, at chip_smoke.py's tolerance.
The wrappers' device-independent checks run on CPU and meta tensors.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_hopper_attention import tiled_online
from videoitg_tpu.ops import flash_attention_train as jax_fat
from videoitg_tpu_torch.ops import flash_attention_train as fat
from videoitg_tpu_torch.ops._kernel_args import check_layout

TOL = dict(atol=2e-5, rtol=1e-4)
KEYS = 128  # keys per block of kernel E (hattn::kDkvKeys), 64 per warpgroup
ROWS = 64   # query rows per ring stage (hattn::kDkvRows)
LOG2E = math.log2(math.e)

# b, hq, hkv, s, d, valid lengths: GQA 6/2 at S = 300 (ragged against the
# 128-key and 64-row tiles), two rows of different valid lengths, D = 72.
CASES = {
    "gqa-6-2-d72": (2, 6, 2, 300, 72, (300, 170)),
    "gqa-6-2-d16": (1, 6, 2, 300, 16, (261,)),
}


def tiled_dkv(q, k, v, valid, do, lse, delta, causal=False, seen=None):
    """Kernel E's arithmetic on its own inputs (`do` zero on invalid rows,
    `delta` given): per block of 128 keys, the group's q heads in order, each
    in 64-row query tiles from the first that can see the block (causal);
    p = exp2(s * scale log2 e - lse log2 e), 0 where the key is invalid or
    (causal) after the query; ds = p (dp - delta); dV += bf16(p)^T dO, dK +=
    bf16(ds)^T Q in fp32; dK times sm_scale at the end. With `seen` (a mask
    policy of tests/test_torch_hopper_dq_attention.py: seen(rows, keys) ->
    [B, 1, R, K]) in place of `valid`, the same kernel's other instance (J's
    dK/dV: segment ids)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    dt = q.dtype
    sl = d ** -0.5 * LOG2E
    qh, doh = (x.float().view(b, hkv, group, s, d) for x in (q, do))
    lse2 = (lse * LOG2E).view(b, hkv, group, s)
    dl = delta.view(b, hkv, group, s)
    key_ok = torch.ones(b, s, dtype=torch.bool) if valid is None else valid
    dk, dv = torch.zeros(b, hkv, s, d), torch.zeros(b, hkv, s, d)
    for k0 in range(0, s, KEYS):
        keys = torch.arange(k0, min(k0 + KEYS, s))
        kt, vt = k[:, :, keys].float(), v[:, :, keys].float()
        acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
        for g in range(group):
            for q0 in range(k0 // ROWS * ROWS if causal else 0, s, ROWS):
                rows = torch.arange(q0, min(q0 + ROWS, s))
                st = kt @ qh[:, :, g, rows].transpose(-1, -2)    # [b, hkv, keys, rows]
                dpt = vt @ doh[:, :, g, rows].transpose(-1, -2)
                ok = (key_ok[:, None, keys, None].expand(b, 1, len(keys), len(rows))
                      if seen is None else seen(rows, keys).transpose(-1, -2))
                if causal:
                    ok = ok & (keys[:, None] <= rows[None, :])
                p = torch.where(ok, torch.exp2(st * sl - lse2[:, :, g, None, rows]), 0.0)
                ds = p * (dpt - dl[:, :, g, None, rows])
                acc_v += p.to(dt).float() @ doh[:, :, g, rows]
                acc_k += ds.to(dt).float() @ qh[:, :, g, rows]
        dk[:, :, keys] = acc_k * d ** -0.5
        dv[:, :, keys] = acc_v
    return dk.to(k.dtype), dv.to(v.dtype)


def _inputs(seed, b, hq, hkv, s, d, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    valid = np.arange(s)[None] < np.asarray(lengths)[:, None]
    valid[:, 5] = False  # a hole inside the first tiles
    return q, k, v, do, valid


def _jax_lse(q, k, v, valid, causal):
    """lse of the Pallas forward `_fwd` (interpret mode), [B, Hq, S]."""
    valid_j = jnp.asarray(valid)
    kbias = jnp.where(valid_j, 0.0, -1e30).astype(jnp.float32)[:, None, :]
    qvalid = valid_j.astype(jnp.float32)[:, None, :]
    _, lse = jax_fat._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kbias, qvalid, causal,
                          128, 128, True)
    return np.asarray(lse)[:, :, :q.shape[2], 0]


def _jax_forward_and_grads(q, k, v, do, valid, causal):
    valid_j = jnp.asarray(valid)

    def run(q, k, v):
        return jax_fat.flash_mha_train(q, k, v, valid=valid_j, causal=causal, block_q=128,
                                       block_k=128, interpret=True)

    out = run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda q, k, v: jnp.sum(run(q, k, v) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _rel(a, b):
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_c_order_matches_jax_forward(case, causal):
    q, k, v, _, valid = _inputs(10, *CASES[case])
    want_o, _ = _jax_forward_and_grads(q, k, v, np.zeros_like(q), valid, causal)
    want_lse = _jax_lse(q, k, v, valid, causal)
    o, lse = tiled_online(*(torch.from_numpy(x) for x in (q, k, v, valid)), causal=causal,
                          with_lse=True)
    rows = np.broadcast_to(valid[:, None, :, None], o.shape)
    np.testing.assert_allclose(o.numpy() * rows, want_o * rows, **TOL)
    assert not o.numpy()[~rows].any()  # invalid query rows are exact zeros
    # Rows that see a valid key (invalid query rows included) have the JAX
    # kernel's finite lse; the JAX kernel marks the others with 1e30, C with +inf.
    live = want_lse < 1e29
    assert np.array_equal(np.isfinite(lse.numpy()), live)
    assert (lse.numpy()[~live] == np.inf).all()
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live], **TOL)
    # ... and both are the logsumexp of the masked scores.
    b, hq, hkv, s, d, _ = CASES[case]
    scores = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, hq // hkv, axis=1)) * d ** -0.5
    mask = np.broadcast_to(valid[:, None, None, :], scores.shape).copy()
    if causal:
        mask &= np.tril(np.ones((s, s), bool))[None, None]
    with np.errstate(divide="ignore"):
        exact = np.log(np.where(mask, np.exp(scores.astype(np.float64)), 0.0).sum(-1))
    np.testing.assert_allclose(lse.numpy()[live], exact[live], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_e_order_matches_jax_gradients(case, causal):
    q, k, v, do, valid = _inputs(11, *CASES[case])
    _, (_, want_dk, want_dv) = _jax_forward_and_grads(q, k, v, do, valid, causal)
    tq, tk, tv, tdo, tvalid = (torch.from_numpy(x) for x in (q, k, v, do, valid))
    o, lse = tiled_online(tq, tk, tv, tvalid, causal=causal, with_lse=True)
    do0, delta = fat.prepare_backward(tvalid, o, tdo)
    dk, dv = tiled_dkv(tq, tk, tv, tvalid, do0, lse, delta, causal)
    for name, got, want in (("dk", dk.numpy(), want_dk), ("dv", dv.numpy(), want_dv)):
        assert _rel(got, want) < 1e-3, (name, _rel(got, want))
        # Invalid keys get exactly 0.
        dead = ~np.broadcast_to(valid[:, None, :, None], got.shape)
        assert not got[dead].any(), name


def _bf16_tol(ref):
    """chip_smoke.py's tolerance: 4 bf16 half-ulps of max|ref|."""
    return 4 * 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 8)


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_orders_match_plain_versions_in_bf16(causal):
    """In the kernels' operand type the two orders agree with the plain
    versions (which round at the same points) within chip_smoke.py's
    tolerance: only the fp32 summation order and exp2 against exp differ."""
    q, k, v, do, valid = (torch.from_numpy(x) for x in _inputs(12, *CASES["gqa-6-2-d72"]))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    ref_o, ref_lse = fat.flash_mha_train_reference(q, k, v, valid, causal)
    o, lse = tiled_online(q, k, v, valid, causal=causal, with_lse=True)
    assert (o.float() - ref_o.float()).abs().max() <= _bf16_tol(ref_o.float())
    live = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - ref_lse[live]).abs().max() <= 1e-3
    do0, delta = fat.prepare_backward(valid, ref_o, do)
    _, ref_dk, ref_dv = fat.backward_on_kernel_inputs(q, k, v, valid, do0, ref_lse, delta, causal)
    dk, dv = tiled_dkv(q, k, v, valid, do0, ref_lse, delta, causal)
    for got, ref in ((dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.bfloat16
        assert (got.float() - ref.float()).abs().max() <= _bf16_tol(ref.float())


def test_wrappers_refuse_misaligned_and_noncontiguous_operands():
    """TMA's tensor maps need contiguous, 16-byte-aligned bases: both are
    refused before any pointer reaches CUDA."""
    base = torch.zeros(2 * 8 * 72 + 4, dtype=torch.bfloat16)
    shifted = base[4:4 + 2 * 8 * 72].view(1, 2, 8, 72)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_layout("flash_train_fwd", shifted)
    strided = torch.zeros(1, 8, 2, 72, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        check_layout("flash_train_dkv", strided)
    # CPU tensors reach the kernel path only through the plain versions.
    q = torch.zeros(1, 2, 8, 72, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fat._check("flash_train_dkv", q, q, q, None, extra=(q,))


def test_wrappers_refuse_shapes_beyond_the_grid():
    """The shapes the kernels refuse, on meta tensors (no memory)."""
    q = torch.empty(1, 6, 8, 8, device="meta")
    kv = torch.empty(1, 2, 8, 8, device="meta")
    valid = torch.ones(1, 8, dtype=torch.bool, device="meta")
    fat.check_shapes("flash_train_fwd", q, kv, kv, valid, extra=(q,))
    big = torch.empty(65536, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        fat.check_shapes("flash_train_fwd", big, big, big, None)
    heads = torch.empty(1, 65536, 8, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        fat.check_shapes("flash_train_dq", heads, heads, heads, None)
    long_q = torch.empty(1, 1, 2 ** 31, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        fat.check_shapes("flash_train_dkv", long_q, long_q, long_q, None)
    with pytest.raises(ValueError, match="multiple"):
        fat.check_shapes("flash_train_fwd", q, q[:, :4], q[:, :4], None)
    with pytest.raises(ValueError, match="do not match"):
        fat.check_shapes("flash_train_fwd", q, kv[:, :, :4], kv[:, :, :4], None)
    with pytest.raises(ValueError, match="dO"):
        fat.check_shapes("flash_train_dkv", q, kv, kv, None, extra=(q[:, :, :4],))
    with pytest.raises(ValueError, match="valid"):
        fat.check_shapes("flash_train_fwd", q, kv, kv, valid.to(torch.uint8))
