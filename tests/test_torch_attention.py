"""The port's attention against the JAX package's kernels (interpret mode on CPU).

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_flash_*.py
do. Inputs are made with numpy from a seed and handed to both. fp32
throughout; tolerance atol 2e-5, rtol 1e-4 (tests/test_flash_attention.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoitg_tpu.ops.attention import mha_reference as jax_mha_reference
from videoitg_tpu.ops.flash_attention import flash_mha as jax_flash_mha
from videoitg_tpu.ops.flash_attention_short import flash_mha_short as jax_flash_mha_short
from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops import flash_attention as port_flash
from videoitg_tpu_torch.ops import flash_attention_short as port_short
from videoitg_tpu_torch.ops.attention import mha, mha_reference
from videoitg_tpu_torch.ops.flash_attention import flash_mha, flash_mha_reference
from videoitg_tpu_torch.ops.flash_attention_short import flash_mha_short

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(rng, b, hq, hkv, s, d):
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _valid(rng, b, s, frac=0.2):
    valid = rng.random((b, s)) > frac
    valid[:, 0] = True
    valid[0, s - 7:] = False  # a padded tail, as the packed LM layout has
    return valid


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,s,d", [(4, 2, 50, 72), (4, 2, 129, 16), (28, 4, 129, 8),
                                        (28, 4, 50, 128)])
def test_flash_mha_matches_jax_kernel(hq, hkv, s, d, causal):
    rng = np.random.default_rng(hq * 1000 + s + d)
    q, k, v = _qkv(rng, 2, hq, hkv, s, d)
    valid = _valid(rng, 2, s)
    want = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid=jnp.asarray(valid),
                         causal=causal, block_q=128, block_k=128, interpret=True)
    got = flash_mha(*_t(q, k, v), valid=torch.from_numpy(valid), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # Invalid query rows are exactly zero in both.
    np.testing.assert_array_equal(got.numpy()[~np.broadcast_to(valid[:, None], got.shape[:3])], 0.0)


def test_flash_mha_no_mask_matches_jax_kernel():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 1, 4, 4, 129, 72)
    want = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(flash_mha(*_t(q, k, v)).numpy(), np.asarray(want), **TOL)


def test_flash_mha_fully_masked_rows_are_zero():
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 4, 2, 50, 16)
    valid = np.ones((2, 50), dtype=bool)
    valid[0] = False  # nothing valid in batch 0
    got = flash_mha(*_t(q, k, v), valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    assert np.abs(got[1].numpy()).max() > 0
    # A causal row whose visible prefix is all invalid gives future keys no
    # weight: rows 0..9 see only invalid keys 0..9.
    valid = np.ones((1, 50), dtype=bool)
    valid[0, :10] = False
    q, k, v = _qkv(rng, 1, 4, 2, 50, 16)
    got = flash_mha(*_t(q, k, v), valid=torch.from_numpy(valid), causal=True)
    want = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid=jnp.asarray(valid),
                         causal=True, block_q=128, block_k=128, interpret=True)
    np.testing.assert_array_equal(got[:, :, :10].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,h,s,d", [(2, 4, 50, 72), (2, 16, 129, 72), (1, 16, 729, 72),
                                     (2, 6, 37, 8)])
def test_flash_mha_short_matches_jax_kernel(b, h, s, d):
    rng = np.random.default_rng(s + d)
    q, k, v = _qkv(rng, b, h, h, s, d)
    want = jax_flash_mha_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    got = flash_mha_short(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_mha_short_honours_sm_scale():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 4, 4, 50, 72)
    want = jax_flash_mha_short(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                               sm_scale=0.3)
    got = flash_mha_short(*_t(q, k, v), sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(causal):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 28, 4, 61, 8)
    valid = _valid(rng, 2, 61)
    want = jax_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             valid=jnp.asarray(valid), causal=causal)
    got = mha_reference(*_t(q, k, v), valid=torch.from_numpy(valid), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The kernel's plain version differs from the oracle only on invalid query rows.
    flash = flash_mha_reference(*_t(q, k, v), valid=torch.from_numpy(valid), causal=causal)
    rows = np.broadcast_to(valid[:, None, :, None], flash.shape)
    np.testing.assert_array_equal(flash.numpy()[rows], got.numpy()[rows])


@pytest.mark.parametrize("case,want", [
    (dict(hkv=4, s=50, valid=False, causal=False), "short"),
    (dict(hkv=4, s=1024, valid=False, causal=False), "short"),
    (dict(hkv=4, s=1025, valid=False, causal=False), "flash"),
    (dict(hkv=4, s=50, valid=True, causal=False), "flash"),
    (dict(hkv=4, s=50, valid=False, causal=True), "flash"),
    (dict(hkv=2, s=50, valid=False, causal=False), "flash"),
])
def test_mha_dispatch_rule(monkeypatch, case, want):
    """The JAX package's rule: unmasked, non-causal, S <= 1024, Hq == Hkv ->
    short kernel; everything else streams."""
    called = []
    monkeypatch.setattr(port_short, "flash_mha_short",
                        lambda q, k, v, sm_scale=None: called.append("short") or q)
    monkeypatch.setattr(port_flash, "flash_mha",
                        lambda q, k, v, valid=None, causal=False: called.append("flash") or q)
    s = case["s"]
    q = torch.zeros(1, 4, s, 8)
    k = torch.zeros(1, case["hkv"], s, 8)
    valid = torch.ones(1, s, dtype=torch.bool) if case["valid"] else None
    mha(q, k, k, valid=valid, causal=case["causal"], use_flash=True)
    assert called == [want]
    called.clear()
    mha(q, k, k, valid=valid, causal=case["causal"], use_flash=False)
    assert called == []


def test_mha_unported_arms_raise():
    """The training arm is ported (tests/test_torch_train_attention.py) and
    takes no scale override; the A/B arm over the library kernel is not."""
    q = torch.zeros(1, 2, 8, 8)
    assert mha(q, q, q, use_flash="train").shape == q.shape
    with pytest.raises(NotImplementedError, match="train-jax"):
        mha(q, q, q, use_flash="train-jax")
    with pytest.raises(ValueError):
        mha(q, q, q, use_flash="train", sm_scale=0.1)
    with pytest.raises(ValueError):
        mha(q, q, q, valid=torch.ones(1, 8, dtype=torch.bool), use_flash=True, sm_scale=0.1)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel path, which checks its operands
    and raises; it never falls back to the plain version."""
    q = torch.empty(1, 2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_mha(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mha_short(q, q, q)
    assert flash_mha.launches == 0 and flash_mha_short.launches == 0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A CUDA launch on a machine without the toolkit raises instead of
    falling back."""
    monkeypatch.setenv("VIDEOITG_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("VIDEOITG_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="VIDEOITG_NVCC"):
        _build.build()
    assert not any(tmp_path.iterdir())
