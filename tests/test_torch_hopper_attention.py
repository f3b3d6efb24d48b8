"""The order of sums of the TMA + wgmma kernels A and B, held to the JAX kernels.

csrc/hopper_attention.cuh walks keys in tiles of 128: kernel B (`flash_mha`)
keeps a running max and sum per tile and rescales O by alpha; kernel A
(`flash_mha_short`) walks K once for the row max and sum and again for P V with
P divided by its sum before it is rounded. The card runs that order; here it
is written out in PyTorch (`tiled_online`, `tiled_two_pass`) and held to the
Pallas kernels `_flash_kernel` and `_short_kernel` in interpret mode, fp32,
at tests/test_torch_attention.py's tolerance (atol 2e-5, rtol 1e-4). The
wrappers' device-independent checks run on CPU and meta tensors.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoitg_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from videoitg_tpu.ops.flash_attention_short import flash_mha_short as jax_flash_mha_short
from videoitg_tpu_torch.ops import flash_attention as port_flash
from videoitg_tpu_torch.ops import flash_attention_short as port_short
from videoitg_tpu_torch.ops._kernel_args import check_layout

TOL = dict(atol=2e-5, rtol=1e-4)
BLOCK_N = 128  # keys per tile (hattn::kBlockN)


def _scores(q, k, k0, sm_scale):
    """Raw scores of one key tile and exp2's scale (scale folded as in the kernel)."""
    return (q.float() @ k[..., k0:k0 + BLOCK_N, :].float().transpose(-1, -2),
            sm_scale * math.log2(math.e))


def tiled_online(q, k, v, valid=None, causal=False, with_lse=False, seen=None, sm_scale=None):
    """Kernel B's arithmetic: per 128-key tile the running max (a row with no
    visible key keeps -inf and takes base 0), p = exp2(s * scale - base *
    scale) rounded to v's type, O and the sum rescaled by alpha; O / sum at
    the end, 0 for invalid rows and rows with no visible valid key. With
    `with_lse` (kernel C) also lse = (max * scale + log2 sum) * ln 2 in fp32,
    +inf where the sum is 0: returns (o, lse). With `seen` (a mask policy of
    tests/test_torch_hopper_dq_attention.py: seen(rows, keys) -> [B, 1, R, K])
    and `sm_scale` 1 on a pre-scaled q, kernel K: the same kernel with the
    segment-id policy, where only a row that sees no key is 0."""
    b, hq, s, d = q.shape
    scale = d ** -0.5 if sm_scale is None else sm_scale
    group = hq // k.shape[1]
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    m = torch.full((b, hq, s), -math.inf)
    l = torch.zeros(b, hq, s)
    acc = torch.zeros(b, hq, s, d)
    rows = torch.arange(s)
    for k0 in range(0, s, BLOCK_N):
        sc, sl = _scores(q, k, k0, scale)
        keys = torch.arange(k0, min(k0 + BLOCK_N, s))
        ok = torch.ones(b, 1, s, keys.numel(), dtype=torch.bool)
        if valid is not None:
            ok = ok & valid[:, None, None, keys]
        if seen is not None:
            ok = ok & seen(rows, keys)
        if causal:
            ok = ok & (keys[None, :] <= rows[:, None])
        sc = torch.where(ok, sc, -math.inf)
        mn = torch.maximum(m, sc.amax(-1))
        base = torch.where(mn == -math.inf, 0.0, mn)
        alpha = torch.exp2((m - base) * sl)
        p = torch.exp2(sc * sl - (base * sl)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ v[..., k0:k0 + BLOCK_N, :].float()
        m = mn
    ok_rows = l > 0
    if valid is not None:
        ok_rows = ok_rows & valid[:, None, :]
    o = torch.where(ok_rows[..., None], acc / torch.where(ok_rows, l, 1.0)[..., None], 0.0)
    if not with_lse:
        return o
    sl = scale * math.log2(math.e)
    lse = torch.where(l > 0, (m * sl + torch.log2(torch.where(l > 0, l, 1.0))) * math.log(2.0),
                      math.inf)
    return o.to(q.dtype), lse


def tiled_two_pass(q, k, v, sm_scale=None):
    """Kernel A's arithmetic: pass 1 the running max and sum per 128-key tile
    (the sum rescaled when the max grows), pass 2 p = exp2(s * scale - max *
    scale) times 1 / sum, rounded to v's type, into P V."""
    b, h, s, d = q.shape
    scale = d ** -0.5 if sm_scale is None else sm_scale
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros(b, h, s)
    for k0 in range(0, s, BLOCK_N):
        sc, sl = _scores(q, k, k0, scale)
        mn = torch.maximum(m, sc.amax(-1))
        l = l * torch.exp2((m - mn) * sl) + torch.exp2(sc * sl - (mn * sl)[..., None]).sum(-1)
        m = mn
    r = 1.0 / l
    acc = torch.zeros(b, h, s, d)
    for k0 in range(0, s, BLOCK_N):
        sc, sl = _scores(q, k, k0, scale)
        p = torch.exp2(sc * sl - (m * sl)[..., None]) * r[..., None]
        acc = acc + p.to(v.dtype) @ v[..., k0:k0 + BLOCK_N, :]
    return acc


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv))
    valid = rng.random((b, s)) > 0.2
    valid[:, 0] = True
    valid[0, s - 9:] = False  # a padded tail
    if s > 140:
        valid[-1, 128:140] = False  # a hole across the first tile edge
    return q, k, v, valid


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,s,d", [(28, 4, 300, 72), (12, 4, 257, 16), (8, 8, 130, 128),
                                        (4, 2, 50, 8)])
def test_tiled_online_matches_jax_flash_kernel(hq, hkv, s, d, causal):
    q, k, v, valid = _inputs(hq * 100 + s + d, 2, hq, hkv, s, d)
    want = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid=jnp.asarray(valid),
                         causal=causal, block_q=128, block_k=128, interpret=True)
    got = tiled_online(*(torch.from_numpy(x) for x in (q, k, v, valid)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rows = np.broadcast_to(valid[:, None, :, None], got.shape)
    np.testing.assert_array_equal(got.numpy()[~rows], 0.0)


def test_tiled_online_without_mask_matches_jax_flash_kernel():
    q, k, v, _ = _inputs(7, 1, 4, 4, 300, 72)
    want = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                         block_k=128, interpret=True)
    got = tiled_online(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,h,s,d,sm_scale", [(1, 4, 300, 72, None), (2, 2, 257, 8, None),
                                              (1, 2, 129, 128, None), (1, 3, 200, 40, 0.3)])
def test_tiled_two_pass_matches_jax_short_kernel(b, h, s, d, sm_scale):
    q, k, v, _ = _inputs(s + d, b, h, h, s, d)
    kwargs = {} if sm_scale is None else dict(sm_scale=sm_scale)
    want = jax_flash_mha_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                               **kwargs)
    got = tiled_two_pass(*(torch.from_numpy(x) for x in (q, k, v)), sm_scale=sm_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_operands_must_be_16_byte_aligned():
    """TMA's tensor maps need 16-byte-aligned bases: a tensor that starts 8
    bytes into its storage is refused before any pointer reaches CUDA."""
    base = torch.zeros(2 * 8 * 72 + 4, dtype=torch.bfloat16)
    check_layout("flash_mha", base[:2 * 8 * 72].view(1, 2, 8, 72))
    shifted = base[4:4 + 2 * 8 * 72].view(1, 2, 8, 72)
    assert shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_layout("flash_mha", shifted)
    with pytest.raises(ValueError, match="bfloat16"):
        check_layout("flash_mha", torch.zeros(1, 2, 8, 72))
    with pytest.raises(ValueError, match="head dim"):
        check_layout("flash_mha", torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16))


def test_refused_shapes():
    """Shapes beyond the grid or the contract are refused (meta tensors: no memory)."""
    q = torch.empty(1, 4, 8, 8, device="meta")
    port_short.check_shapes(q, q, q)
    with pytest.raises(ValueError, match="must match"):
        port_short.check_shapes(q, q[:, :2], q[:, :2])
    big = torch.empty(65536, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="65535"):
        port_short.check_shapes(big, big, big)

    kv = torch.empty(1, 2, 8, 8, device="meta")
    valid = torch.ones(1, 8, dtype=torch.bool, device="meta")
    port_flash.check_shapes(q, kv, kv, valid)
    with pytest.raises(ValueError, match="multiple"):
        port_flash.check_shapes(q, q[:, :3], q[:, :3], None)
    with pytest.raises(ValueError, match="do not match"):
        port_flash.check_shapes(q, kv[:, :, :4], kv[:, :, :4], None)
    long_q = torch.empty(1, 1, 2 ** 31, 8, device="meta")
    with pytest.raises(ValueError, match="grid"):
        port_flash.check_shapes(long_q, long_q, long_q, None)
    with pytest.raises(ValueError, match="valid"):
        port_flash.check_shapes(q, kv, kv, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="valid"):
        port_flash.check_shapes(q, kv, kv, valid[:, :4])
