"""The `"train-jax"` attention arm of the port against the JAX package's.

`mha_trainable` / `mha(use_flash="train-jax")` of the JAX package reach jax's
library flash attention for the TPU (forward, dkv, dq kernels), which has no
`interpret` argument of its own: the test runs it inside
`jax.experimental.pallas.tpu.force_tpu_interpret_mode()`. The port runs the
plain version of its segment-id kernels
(videoitg_tpu_torch/ops/flash_attention_segment.py), as it does for every CPU
tensor.

ALL rows are compared, the invalid ones too: in this arm an invalid query is
not zero, it attends the other invalid keys and the zero padding up to the
next multiple of 512. fp32, inputs from numpy seeds. Tolerances: values 2e-5
absolute / 1e-4 relative, gradients (dq, and dk / dv through the KV repeat)
1e-3; both sides are fp32 and differ by the order of their sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from videoitg_tpu.ops import attention as jax_attention
from videoitg_tpu_torch.ops import attention
from videoitg_tpu_torch.ops import flash_attention_segment as fas

ATOL, RTOL, GRAD_TOL = 2e-5, 1e-4, 1e-3


def _inputs(seed, b, hq, hkv, s, d, valid_kind):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, hq, s, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, s, d), dtype=np.float32) for _ in range(2))
    if valid_kind is None:
        return q, k, v, do, None
    valid = np.ones((b, s), bool)
    if valid_kind == "prefix":
        valid[:, s - s // 4:] = False
    elif valid_kind == "hole":  # invalid slots mid-sequence and at the end
        valid[:, s // 3: s // 2] = False
        valid[:, -3:] = False
    elif valid_kind == "ragged":  # another valid length per batch row
        for i in range(b):
            valid[i, s - 5 - 7 * i:] = False
    return q, k, v, do, valid


def _jax_arm(q, k, v, do, valid, causal):
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda q_, k_, v_: jax_attention.mha(
                q_, k_, v_, valid=None if valid is None else jnp.asarray(valid), causal=causal,
                use_flash="train-jax"),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(do))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_arm(q, k, v, do, valid, causal, use_flash="train-jax"):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention.mha(tq, tk, tv, valid=None if valid is None else torch.from_numpy(valid),
                        causal=causal, use_flash=use_flash)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


CASES = {
    "gqa 4/2, D 16, causal, a hole mid-sequence": (1, 4, 2, 40, 16, True, "hole"),
    "gqa 4/2, D 128, valid prefix": (1, 4, 2, 300, 128, False, "prefix"),
    "the tower's heads: mha, D 72, S 729, no mask": (2, 2, 2, 729, 72, False, None),
    "gqa 4/2, D 8, causal, S 600 (two blocks of 512)": (1, 4, 2, 600, 8, True, "prefix"),
    "the LM's heads: gqa 28/4, D 16, ragged rows": (2, 28, 4, 70, 16, False, "ragged"),
    "gqa 28/4, D 8, causal, ragged rows": (2, 28, 4, 50, 8, True, "ragged"),
    "mha, D 72, causal, no mask": (1, 3, 3, 130, 72, True, None),
    "gqa 4/2, D 128, a hole mid-sequence, S 513": (1, 4, 2, 513, 128, False, "hole"),
}


@pytest.mark.parametrize("case", CASES)
def test_train_jax_arm_matches_jax_on_every_row(case):
    b, hq, hkv, s, d, causal, valid_kind = CASES[case]
    q, k, v, do, valid = _inputs(sum(map(ord, case)), b, hq, hkv, s, d, valid_kind)
    want, want_grads = _jax_arm(q, k, v, do, valid, causal)
    got, got_grads = _port_arm(q, k, v, do, valid, causal)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for name, g, w in zip(("dq", "dk", "dv"), got_grads, want_grads):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
    if valid is not None:
        # What sets this arm apart: invalid query rows are computed.
        assert np.abs(want[:, :, ~valid[0]]).max() > 1e-3
        assert np.abs(got[:, :, ~valid[0]]).max() > 1e-3


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 2, 37, 16), (1, 28, 4, 20, 8), (1, 16, 16, 65, 72)])
def test_valid_rows_equal_the_native_gqa_arm_and_the_oracle(shape, causal):
    """On valid rows the three paths compute one function; they differ on the
    invalid rows only (the oracle: attends the valid keys; "train": exact 0;
    "train-jax": attends the invalid keys and the padding)."""
    q, k, v, do, valid = _inputs(5, *shape, "hole")
    rows = valid[0]
    do[:, :, ~rows] = 0  # so that the invalid rows add nothing to dk, dv in any arm
    oracle, oracle_grads = _port_arm(q, k, v, do, valid, causal, use_flash=False)
    native, native_grads = _port_arm(q, k, v, do, valid, causal, use_flash="train")
    got, got_grads = _port_arm(q, k, v, do, valid, causal)
    for other, other_grads in ((oracle, oracle_grads), (native, native_grads)):
        np.testing.assert_allclose(got[:, :, rows], other[:, :, rows], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got_grads[0][:, :, rows], other_grads[0][:, :, rows],
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
        for g, w in zip(got_grads[1:], other_grads[1:]):
            np.testing.assert_allclose(g[:, :, rows], w[:, :, rows], atol=GRAD_TOL, rtol=GRAD_TOL)


def _ids(seed, b, s, values):
    rng = np.random.default_rng(seed)
    return np.asarray(values, np.int32)[rng.integers(0, len(values), (b, s))]


def _dense_oracle(q, k, v, q_ids, kv_ids, causal):
    """The port's own oracle: one softmax row at a time over the keys whose id
    equals the query's (and, causal, lie at or before it); 0 where none does."""
    b, h, s, d = q.shape
    out = np.zeros_like(q)
    for bi in range(b):
        for i in range(s):
            keys = np.flatnonzero((kv_ids[bi] == q_ids[bi, i])
                                  & (np.arange(s) <= i if causal else True))
            if keys.size == 0:
                continue
            logits = np.einsum("hd,hkd->hk", q[bi, :, i], k[bi][:, keys]) * d ** -0.5
            p = np.exp(logits - logits.max(axis=-1, keepdims=True))
            p /= p.sum(axis=-1, keepdims=True)
            out[bi, :, i] = np.einsum("hk,hkd->hd", p, v[bi][:, keys])
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("apart", [False, True], ids=["one id array", "q and kv ids apart"])
def test_three_segment_ids_against_the_dense_oracle(causal, apart):
    b, h, s, d = 2, 3, 45, 16
    q, k, v, do, _ = _inputs(6, b, h, h, s, d, None)
    kv_ids = _ids(7, b, s, (-3, 5, 1000))
    q_ids = _ids(8, b, s, (-3, 5, 1000, 77)) if apart else kv_ids  # no key has id 77
    want = _dense_oracle(q, k, v, q_ids, kv_ids, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tqi, tki = torch.from_numpy(q_ids), torch.from_numpy(kv_ids)
    got = fas.flash_mha_segment(tq, tk, tv, tqi, tki, causal)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    # The differentiable plain version and the kernels' plain versions agree,
    # forward and backward.
    rq, rk, rv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ref = fas.flash_mha_segment_reference(rq, rk, rv, tqi, tki, causal)
    np.testing.assert_allclose(ref.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    got.backward(torch.from_numpy(do))
    ref.backward(torch.from_numpy(do))
    for a, r in zip((tq, tk, tv), (rq, rk, rv)):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL)
    # A row that sees no key: 0 out, lse +inf, no gradient. With one id array
    # there is none (a row sees itself).
    o, lse = fas.flash_segment_fwd(tq.detach(), tk.detach(), tv.detach(), tqi, tki, causal)
    empty = ~fas.segment_visible(tqi, tki, causal)[:, 0].any(dim=-1).numpy()  # [B, S]
    assert empty.any() == apart
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.repeat(empty[:, None], h, axis=1))
    if apart:
        assert np.abs(o.numpy().transpose(0, 2, 1, 3)[empty]).max() == 0
        assert np.abs(tq.grad.numpy().transpose(0, 2, 1, 3)[empty]).max() == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 33, 8), (2, 5, 70, 24)])
def test_written_out_backward_equals_autograd_of_the_plain_forward(shape, causal):
    b, h, s, d = shape
    q, k, v, do, _ = _inputs(9, b, h, h, s, d, None)
    ids = torch.from_numpy(_ids(10, b, s, (0, 1)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fas.flash_mha_segment_reference(tq, tk, tv, ids, ids, causal)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    with torch.no_grad():
        o, lse = fas.flash_segment_fwd_reference(tq, tk, tv, ids, ids, causal)
        got = fas.flash_mha_segment_backward_reference(tq, tk, tv, ids, ids, o, lse,
                                                       torch.from_numpy(do), causal)
    torch.testing.assert_close(o, out.detach(), atol=ATOL, rtol=RTOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)
    # lse is the row's log-sum-exp of the scaled, visible scores.
    scores = torch.einsum("bhqd,bhkd->bhqk", tq.detach(), tk.detach()) * d ** -0.5
    scores = scores.masked_fill(~fas.segment_visible(ids, ids, causal), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1), atol=1e-5, rtol=1e-5)
    # The backward pieces on their own inputs are what the whole returns.
    delta = fas.segment_delta(o, torch.from_numpy(do))
    dq = fas.flash_segment_dq(tq.detach(), tk.detach(), tv.detach(), ids, ids,
                              torch.from_numpy(do), lse, delta, causal)
    dk, dv = fas.flash_segment_dkv(tq.detach(), tk.detach(), tv.detach(), ids, ids,
                                   torch.from_numpy(do), lse, delta, causal)
    for a, b_ in zip((dq, dk, dv), got):
        assert torch.equal(a, b_)


def test_head_chunks_of_the_plain_versions_change_nothing(monkeypatch):
    """The written-out plain versions walk the heads a few at a time to bound
    their [S, S] scores: the chunk size is not part of the result."""
    q, k, v, do, _ = _inputs(11, 1, 6, 6, 30, 8, None)
    ids = torch.from_numpy(_ids(12, 1, 30, (0, 1)))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    results = []
    for chunk in (4, 1, 6):
        monkeypatch.setattr(fas, "HEAD_CHUNK", chunk)
        o, lse = fas.flash_segment_fwd_reference(*args, ids, ids, True)
        results.append((o, lse, *fas.flash_mha_segment_backward_reference(
            *args, ids, ids, o, lse, torch.from_numpy(do), True)))
    for other in results[1:]:
        for a, b in zip(results[0], other):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_mha_trainable_pads_to_512_and_repeats_kv(monkeypatch):
    """What the arm hands the kernels: KV heads repeated to Hq, S padded to a
    multiple of 512 with zeros, ids `valid` as int32 with the padding in
    segment 0, one id array for both sides; the output cut back to S."""
    seen = {}
    real = fas.flash_mha_segment

    def spy(q, k, v, q_ids, kv_ids, causal=False):
        seen.update(q=q, k=k, v=v, q_ids=q_ids, kv_ids=kv_ids, causal=causal)
        return real(q, k, v, q_ids, kv_ids, causal)

    monkeypatch.setattr(fas, "flash_mha_segment", spy)
    q, k, v, _, valid = _inputs(13, 2, 4, 2, 600, 8, "prefix")
    out = attention.mha_trainable(*(torch.from_numpy(x) for x in (q, k, v)),
                                  valid=torch.from_numpy(valid), causal=True)
    assert tuple(out.shape) == (2, 4, 600, 8) and seen["causal"] is True
    assert tuple(seen["q"].shape) == tuple(seen["k"].shape) == tuple(seen["v"].shape) == \
        (2, 4, 1024, 8)
    assert seen["q_ids"] is seen["kv_ids"] and seen["q_ids"].dtype == torch.int32
    np.testing.assert_array_equal(seen["q_ids"][:, :600].numpy(), valid.astype(np.int32))
    assert not seen["q_ids"][:, 600:].any() and not seen["k"][:, :, 600:].any()
    np.testing.assert_array_equal(seen["k"][:, :, :600].numpy(), np.repeat(k, 2, axis=1))
    # No mask: every real token in segment 1. A multiple of 512: no padding.
    attention.mha_trainable(*(torch.from_numpy(x[:, :, :512]) for x in (q, k, v)))
    assert tuple(seen["q"].shape) == (2, 4, 512, 8) and seen["q_ids"].all()
    with pytest.raises(ValueError, match="not a multiple"):
        attention.mha_trainable(torch.zeros(1, 3, 8, 8), torch.zeros(1, 2, 8, 8),
                                torch.zeros(1, 2, 8, 8))


def test_cpu_runs_count_no_launch_and_a_non_cpu_tensor_never_takes_the_plain_version():
    q, k, v, do, valid = _inputs(14, 1, 2, 2, 20, 8, "prefix")
    _port_arm(q, k, v, do, valid, True)
    assert fas.flash_segment_fwd.launches == 0 and fas.flash_segment_dq.launches == 0
    assert fas.flash_segment_dkv.launches == 0
    meta = torch.empty(1, 2, 8, 8, device="meta")
    ids = torch.empty(1, 8, dtype=torch.int32, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fas.flash_segment_fwd(meta, meta, meta, ids, ids)
    with pytest.raises(ValueError, match="CUDA"):
        fas.flash_segment_dq(meta, meta, meta, ids, ids, meta, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fas.flash_segment_dkv(meta, meta, meta, ids, ids, meta, lse, lse)
    assert fas.flash_segment_fwd.launches == 0


def test_no_grad_keeps_nothing_and_gradients_reach_the_unrepeated_kv():
    q, k, v, do, valid = _inputs(15, 1, 4, 2, 24, 8, "prefix")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        frozen = attention.mha(tq, tk, tv, valid=torch.from_numpy(valid), use_flash="train-jax")
    out = attention.mha(tq, tk, tv, valid=torch.from_numpy(valid), use_flash="train-jax")
    assert frozen.grad_fn is None and torch.equal(frozen, out.detach())
    out.backward(torch.from_numpy(do))
    assert tuple(tk.grad.shape) == (1, 2, 24, 8) and tuple(tv.grad.shape) == (1, 2, 24, 8)
