"""The port's trainable attention (plain versions) against the JAX package.

The same numpy inputs go through `videoitg_tpu.ops.flash_attention_train.
flash_mha_train` (its Pallas kernels in interpret mode) and through the
port's `flash_mha_train`, whose wrappers run the kernels' plain versions on
CPU tensors. fp32. Values: atol 2e-5, rtol 1e-4 on valid rows. Gradients:
max-abs relative error under 1e-3 (2e-3 in the fuzz), the bounds of
tests/test_trainable_attention.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.ops.attention import mha_reference as jax_mha_reference
from videoitg_tpu.ops.flash_attention_train import flash_mha_train as jax_flash_mha_train
from videoitg_tpu_torch.ops import flash_attention_train as fat
from videoitg_tpu_torch.ops.attention import mha, mha_reference

TOL = dict(atol=2e-5, rtol=1e-4)

# b, hq, hkv, s, d, valid lengths: the shapes of tests/test_trainable_attention.py
# (GQA 6/2, several blocks at S = 300, two batch rows of different lengths).
CASES = {
    "gqa-4-2": (1, 4, 2, 100, 16, (87,)),
    "gqa-6-2": (1, 6, 2, 90, 16, (70,)),
    "multiblock": (1, 6, 2, 300, 16, (260,)),
    "two-rows": (2, 4, 2, 128, 16, (128, 77)),
}


def _inputs(seed, b, hq, hkv, s, d, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    valid = np.arange(s)[None] < np.asarray(lengths)[:, None]
    return q, k, v, do, valid


def _jax_forward_and_grads(q, k, v, do, valid, causal, block=128):
    valid_j = jnp.asarray(valid)

    def run(q, k, v):
        return jax_flash_mha_train(q, k, v, valid=valid_j, causal=causal, block_q=block,
                                   block_k=block, interpret=True)

    out = run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda q, k, v: jnp.sum(run(q, k, v) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_forward_and_grads(q, k, v, do, valid, causal):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fat.flash_mha_train(tq, tk, tv, torch.from_numpy(valid), causal)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()]


def _rel(a, b):
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_values_match_jax_kernel_and_reference(case, causal):
    q, k, v, do, valid = _inputs(0, *CASES[case])
    want, _ = _jax_forward_and_grads(q, k, v, do, valid, causal)
    oracle = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          valid=jnp.asarray(valid), causal=causal))
    got, _ = _port_forward_and_grads(q, k, v, do, valid, causal)
    rows = valid[:, None, :, None]
    np.testing.assert_allclose(got * rows, want * rows, **TOL)
    np.testing.assert_allclose(got * rows, oracle * rows, **TOL)
    # Invalid query rows are exact zeros, as in the JAX kernel.
    assert not got[~np.broadcast_to(rows, got.shape)].any()
    assert np.array_equal(got == 0, want == 0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_is_logsumexp_of_masked_scores(case, causal):
    b, hq, hkv, s, d, lengths = CASES[case]
    q, k, v, _, valid = _inputs(1, b, hq, hkv, s, d, lengths)
    _, lse = fat.flash_mha_train_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                           torch.from_numpy(valid), causal)
    kk = np.repeat(k, hq // hkv, axis=1)
    scores = np.einsum("bhqd,bhkd->bhqk", q, kk).astype(np.float64) * d ** -0.5
    mask = np.broadcast_to(valid[:, None, None, :], scores.shape).copy()
    if causal:
        mask &= np.tril(np.ones((s, s), bool))[None, None]
    with np.errstate(divide="ignore"):
        want = np.log(np.where(mask, np.exp(scores), 0.0).sum(-1))
    live = np.isfinite(want)
    assert np.array_equal(np.isfinite(lse.numpy()), live)  # dead rows store +inf
    assert (lse.numpy()[~live] == np.inf).all()
    np.testing.assert_allclose(lse.numpy()[live], want[live], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_kernel(case, causal):
    q, k, v, do, valid = _inputs(2, *CASES[case])
    _, want = _jax_forward_and_grads(q, k, v, do, valid, causal)
    _, got = _port_forward_and_grads(q, k, v, do, valid, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) < 1e-3, (name, _rel(a, b))
    # Exact zeros where the contract says zero: dq on invalid query rows,
    # dk and dv on invalid keys.
    dead = ~np.broadcast_to(valid[:, None, :, None], got[0].shape)
    assert not got[0][dead].any()
    dead_kv = ~np.broadcast_to(valid[:, None, :, None], got[1].shape)
    assert not got[1][dead_kv].any() and not got[2][dead_kv].any()


@pytest.mark.parametrize("causal", [False, True])
def test_explicit_backward_matches_autograd_through_the_oracle(causal):
    """The written-out backward against PyTorch autograd through the port's
    own `mha_reference`, with the loss masked to valid query rows."""
    q, k, v, do, valid = _inputs(3, 2, 6, 2, 150, 24, (150, 101))
    tv_ = torch.from_numpy(valid)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = mha_reference(*leaves, valid=tv_, causal=causal)
    (out * tv_[:, None, :, None] * torch.from_numpy(do)).sum().backward()
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fat.flash_mha_train_reference(tq, tk, tv, tv_, causal)
    got = fat.flash_mha_train_backward_reference(tq, tk, tv, tv_, o, lse,
                                                 torch.from_numpy(do), causal)
    for name, a, leaf in zip(("dq", "dk", "dv"), got, leaves):
        assert _rel(a.numpy(), leaf.grad.numpy()) < 1e-3, name


def test_autograd_function_returns_the_explicit_reference():
    q, k, v, do, valid = _inputs(4, 1, 4, 2, 70, 16, (61,))
    _, got = _port_forward_and_grads(q, k, v, do, valid, False)
    tq, tk, tv, tdo, tvalid = (torch.from_numpy(x) for x in (q, k, v, do, valid))
    o, lse = fat.flash_mha_train_reference(tq, tk, tv, tvalid, False)
    want = fat.flash_mha_train_backward_reference(tq, tk, tv, tvalid, o, lse, tdo, False)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())
    # The two backward wrappers, each on its own inputs, give the same.
    do0, delta = fat.prepare_backward(tvalid, o, tdo)
    assert torch.equal(fat.flash_train_dq(tq, tk, tv, tvalid, do0, lse, delta), want[0])
    dk, dv = fat.flash_train_dkv(tq, tk, tv, tvalid, do0, lse, delta)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])


def test_rows_with_no_visible_valid_key():
    """Causal rows whose visible prefix is all invalid, and a batch row with
    no valid token at all: output 0, lse dead, zero gradient, no NaN."""
    q, k, v, do, valid = _inputs(5, 2, 4, 2, 40, 8, (40, 0))
    valid[0, :3] = False
    out, grads = _port_forward_and_grads(q, k, v, do, valid, True)
    assert np.isfinite(out).all() and all(np.isfinite(g).all() for g in grads)
    assert not out[0, :, :3].any() and not out[1].any()
    assert not grads[0][0, :, :3].any() and not any(g[1].any() for g in grads)
    _, lse = fat.flash_mha_train_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                           torch.from_numpy(valid), True)
    assert (lse[1] == float("inf")).all() and (lse[0, :, :3] == float("inf")).all()
    want, want_grads = _jax_forward_and_grads(q, k, v, do, valid, True)
    np.testing.assert_allclose(out, want, **TOL)
    for a, b in zip(grads, want_grads):
        assert _rel(a, b) < 1e-3


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_against_jax_kernel(seed):
    rng = np.random.default_rng(100 + seed)
    hkv = int(rng.choice([1, 2, 3]))
    group = int(rng.choice([1, 2, 4]))
    s = int(rng.integers(5, 200))
    d = int(rng.choice([8, 16, 24, 72]))
    causal = bool(rng.integers(0, 2))
    b = int(rng.choice([1, 2]))
    lengths = tuple(int(rng.integers(1, s + 1)) for _ in range(b))
    q, k, v, do, valid = _inputs(200 + seed, b, hkv * group, hkv, s, d, lengths)
    want, want_grads = _jax_forward_and_grads(q, k, v, do, valid, causal)
    got, grads = _port_forward_and_grads(q, k, v, do, valid, causal)
    rows = valid[:, None, :, None]
    np.testing.assert_allclose(got * rows, want * rows, **TOL)
    for name, a, b_ in zip(("dq", "dk", "dv"), grads, want_grads):
        assert _rel(a, b_) < 2e-3, (name, hkv, group, s, d, causal, lengths)


def test_no_mask_and_no_grad():
    """valid=None (the tower's call), and under no_grad nothing is saved."""
    q, k, v, do, _ = _inputs(6, 3, 2, 2, 50, 72, (50, 50, 50))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fat.flash_mha_train(tq, tk, tv)
    want = np.asarray(jax_flash_mha_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True))
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    with torch.no_grad():
        frozen = fat.flash_mha_train(tq, tk, tv)
    assert frozen.grad_fn is None and torch.equal(frozen, out.detach())


def test_mha_dispatch_train_arm():
    q, k, v, _, valid = _inputs(7, 1, 4, 2, 33, 16, (30,))
    tq, tk, tv, tvalid = (torch.from_numpy(x) for x in (q, k, v, valid))
    got = mha(tq, tk, tv, valid=tvalid, use_flash="train")
    assert torch.equal(got, fat.flash_mha_train(tq, tk, tv, tvalid))
    # The default scale passed explicitly is the default; another is refused.
    assert torch.equal(mha(tq, tk, tv, valid=tvalid, use_flash="train", sm_scale=16 ** -0.5), got)
    with pytest.raises(ValueError, match="serving-path knob"):
        mha(tq, tk, tv, valid=tvalid, use_flash="train", sm_scale=0.3)
    with pytest.raises(NotImplementedError, match="kernel J"):
        mha(tq, tk, tv, valid=tvalid, use_flash="train-jax")
    with pytest.raises(ValueError, match="unknown use_flash"):
        mha(tq, tk, tv, use_flash="ring")


def test_cpu_runs_count_no_launch_and_operands_are_checked():
    """The plain versions serve CPU tensors only and never count as a launch;
    the operand check that guards every launch refuses what the kernels do
    not take."""
    from videoitg_tpu_torch.ops._kernel_args import check_operands

    q, k, v, do, valid = _inputs(8, 1, 2, 1, 20, 8, (20,))
    _port_forward_and_grads(q, k, v, do, valid, False)
    assert fat.flash_train_fwd.launches == 0 and fat.flash_train_dq.launches == 0
    assert fat.flash_train_dkv.launches == 0
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        check_operands("flash_train_fwd", torch.from_numpy(q))
