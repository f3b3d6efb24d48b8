"""The port's splash arm (`ops/splash_attention.py`) against the JAX package's
`_splash_lm` and the jax library kernel it wraps, run in Pallas interpret
mode on the CPU. The CUDA kernel itself runs only on the card
(chip_smoke.py); here the wrappers run their plain versions, which are the
kernel's arithmetic.

Tolerances: fp32 inputs atol 2e-5 / rtol 1e-4 (two fp32 softmax
implementations with different summation orders, as tests/test_flash_attention.py
uses for the flash kernels); bf16 inputs 2 bf16 ulps of the largest output.
Invalid query rows must be exactly 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.ops import attention as jax_attention
from videoitg_tpu_torch.ops import attention, splash_attention

ATOL, RTOL = 2e-5, 1e-4


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv))


def _valid(b, s, lengths):
    valid = np.zeros((b, s), bool)
    for i, n in enumerate(lengths):
        valid[i, :n] = True
    return valid


CASES = [
    # the case of tests/test_flash_attention.py::test_splash_lm_arm_matches_oracle
    pytest.param((1, 2, 4, 2, 300, 16, (250, 280)), id="b2-gqa4/2-s300-d16"),
    pytest.param((2, 2, 28, 4, 200, 16, (200, 77)), id="b2-gqa28/4-s200-d16"),
    pytest.param((3, 1, 4, 2, 131, 72, (100,)), id="b1-gqa4/2-s131-d72"),
]


@pytest.mark.parametrize("case", CASES)
def test_splash_lm_matches_jax_interpret(case):
    seed, b, hq, hkv, s, d, lengths = case
    q, k, v = _qkv(seed, b, hq, hkv, s, d)
    valid = _valid(b, s, lengths)
    want = np.asarray(jax_attention._splash_lm(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), interpret=True))
    got = splash_attention.splash_lm(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(valid)).numpy()
    m = valid[:, None, :, None]
    np.testing.assert_allclose(got * m, want * m, atol=ATOL, rtol=RTOL)
    assert np.all(got[~np.broadcast_to(m, got.shape)] == 0.0)
    assert np.all(want[~np.broadcast_to(m, want.shape)] == 0.0)
    # and against the port's own oracle, as the JAX test holds its arm to its oracle
    ref = attention.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                  valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got * m, ref * m, atol=ATOL, rtol=RTOL)


def test_reference_three_segments_matches_jax_kernel():
    """Segment ids other than 0 / 1: the plain version against the jax library
    kernel made by `_make_splash_kernel`, interpret mode, one (batch, KV head)
    at a time as `_splash_lm` vmaps it. S is a multiple of the 128 block, so
    the kernel sees no padding and every row is comparable."""
    from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as sk

    hq, hkv, s, d = 4, 2, 256, 16
    group = hq // hkv
    q, k, v = _qkv(5, 1, hq, hkv, s, d)
    ids = np.array([-3, 5, 1000], np.int32)
    seg = ids[np.random.default_rng(6).integers(0, 3, s)]
    seg[:3] = ids  # every id occurs
    kernel = jax_attention._make_splash_kernel(group, s, 128, True)
    sids = sk.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    want = np.stack([np.asarray(kernel(jnp.asarray(q[0].reshape(hkv, group, s, d)[h]),
                                       jnp.asarray(k[0, h]), jnp.asarray(v[0, h]),
                                       segment_ids=sids)) for h in range(hkv)])
    seg_t = torch.from_numpy(seg)[None]
    got = splash_attention.splash_mqa_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), seg_t, seg_t).numpy()
    np.testing.assert_allclose(got[0], want.reshape(hq, s, d), atol=ATOL, rtol=RTOL)
    # A query of one segment must not see a key of another: move the keys of
    # the other segments and the rows of segment 5 stay as they were.
    k2, v2 = k.copy(), v.copy()
    k2[:, :, seg != 5] += 3.0
    v2[:, :, seg != 5] -= 7.0
    moved = splash_attention.splash_mqa_reference(
        torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v2), seg_t, seg_t).numpy()
    np.testing.assert_array_equal(moved[:, :, seg == 5], got[:, :, seg == 5])
    assert np.abs(moved[:, :, seg != 5] - got[:, :, seg != 5]).max() > 1.0


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 1, 4, 2, 40, 8))
    seg = (torch.arange(40)[None] < 30).to(torch.int32)
    before = splash_attention.splash_mqa.launches
    out = splash_attention.splash_mqa(q, k, v, seg, seg)
    assert torch.equal(out, splash_attention.splash_mqa_reference(q, k, v, seg, seg))
    assert splash_attention.splash_mqa.launches == before  # only a kernel launch counts
    # a query whose id matches no key gives 0, not NaN
    none = torch.full_like(seg, 9)
    assert not splash_attention.splash_mqa(q, k, v, none, seg).any()


def test_bf16_prescale_rounds_like_jax():
    """At D = 128 the factor 2^-3.5 is no power of two: scaling q in bf16
    rounds q, which the flash arm (it scales the fp32 scores) does not."""
    rng = np.random.default_rng(8)
    b, hq, hkv, s, d = 1, 4, 2, 160, 128
    q32, k32, v32 = (rng.standard_normal((b, h, s, d)).astype(np.float32) for h in (hq, hkv, hkv))
    valid = _valid(b, s, (140,))
    qj, kj, vj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q32, k32, v32))
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q32, k32, v32))
    # The pre-scale alone, bit for bit.
    want_scaled = np.asarray((qj * (d ** -0.5)).astype(jnp.float32))
    got_scaled = splash_attention.prescale(qt)
    assert got_scaled.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_scaled.float().numpy(), want_scaled)
    in_fp32 = (qt.float() * d ** -0.5).to(torch.bfloat16).float().numpy()
    assert (in_fp32 != want_scaled).mean() > 0.01  # scaling in fp32 rounds differently
    # The whole arm on bf16 inputs: 2 bf16 ulps of the largest output.
    want = np.asarray(jax_attention._splash_lm(qj, kj, vj, jnp.asarray(valid), interpret=True)
                      .astype(jnp.float32))
    got = splash_attention.splash_lm(qt, kt, vt, torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    tol = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    assert not got[:, :, 140:].any()


@pytest.fixture
def which_ran(monkeypatch):
    """Record which kernel wrapper `mha` reached (their plain versions run on
    the CPU)."""
    ran = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            ran.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    import videoitg_tpu_torch.ops.flash_attention as fa
    import videoitg_tpu_torch.ops.flash_attention_short as fas

    spy(splash_attention, "splash_lm")
    spy(fa, "flash_mha")
    spy(fas, "flash_mha_short")
    return ran


DISPATCH = [
    # (lm_splash argument, VIDEOITG_LM_SPLASH, causal, with valid, short shape) -> wrapper
    pytest.param(True, None, False, True, False, "splash_lm", id="argument-on"),
    pytest.param(None, "1", False, True, False, "splash_lm", id="env-on"),
    pytest.param(None, None, False, True, False, "flash_mha", id="default-off"),
    pytest.param(None, "0", False, True, False, "flash_mha", id="env-0"),
    pytest.param(False, "1", False, True, False, "flash_mha", id="argument-off-beats-env"),
    pytest.param(True, "1", True, True, False, "flash_mha", id="causal-stays-with-flash"),
    pytest.param(True, "1", False, False, False, "flash_mha", id="no-mask-stays-with-flash"),
    pytest.param(True, "1", False, False, True, "flash_mha_short", id="short-shape"),
]


@pytest.mark.parametrize("arg,env,causal,with_valid,short,expected", DISPATCH)
def test_mha_takes_the_splash_arm_where_the_jax_dispatch_does(
        which_ran, monkeypatch, arg, env, causal, with_valid, short, expected):
    if env is None:
        monkeypatch.delenv("VIDEOITG_LM_SPLASH", raising=False)
    else:
        monkeypatch.setenv("VIDEOITG_LM_SPLASH", env)
    hq, hkv = (4, 4) if short else (4, 2)
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 1, hq, hkv, 24, 8))
    valid = torch.from_numpy(_valid(1, 24, (20,))) if with_valid else None
    out = attention.mha(q, k, v, valid=valid, causal=causal, use_flash=True, lm_splash=arg)
    assert which_ran == [expected]
    ref = attention.mha_reference(q, k, v, valid=valid, causal=causal)
    if valid is not None:
        ref = ref * valid[:, None, :, None]
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)


def test_the_switch_off_the_kernel_path_changes_nothing(which_ran, monkeypatch):
    """`use_flash=False` (the oracle) and the training arms never read the switch."""
    monkeypatch.setenv("VIDEOITG_LM_SPLASH", "1")
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, 1, 4, 2, 24, 8))
    valid = torch.from_numpy(_valid(1, 24, (20,)))
    attention.mha(q, k, v, valid=valid, use_flash=False, lm_splash=True)
    attention.mha(q, k, v, valid=valid, use_flash="train", lm_splash=True)
    attention.mha(q, k, v, valid=valid, use_flash="train-jax", lm_splash=True)
    assert which_ran == []


def test_jax_dispatch_takes_its_arm_under_the_same_switch(monkeypatch):
    """The reference side of the table above, on the one row that differs
    from the default: the JAX `mha` with the env switch on equals `_splash_lm`."""
    monkeypatch.setenv("VIDEOITG_LM_SPLASH", "1")
    q, k, v = _qkv(11, 1, 4, 2, 130, 16)
    valid = _valid(1, 130, (100,))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    via_mha = np.asarray(jax_attention.mha(*args, valid=jnp.asarray(valid), use_flash=True))
    direct = np.asarray(jax_attention._splash_lm(*args, jnp.asarray(valid), interpret=True))
    np.testing.assert_array_equal(via_mha, direct)
    got = attention.mha(*(torch.from_numpy(x) for x in (q, k, v)),
                        valid=torch.from_numpy(valid), use_flash=True).numpy()
    np.testing.assert_allclose(got, direct, atol=ATOL, rtol=RTOL)


def test_lm_runs_through_the_arm_end_to_end(monkeypatch):
    """The switch reaches the LM through the engine: same scores as the flash
    arm within the fp32 tolerance of the engine tests."""
    from _torch_bridge import bridged_pair, tiny_params
    from videoitg_tpu.utils.common import CharTokenizer
    from videoitg_tpu_torch.config import preset
    from videoitg_tpu_torch.engine import SelectionEngine

    monkeypatch.delenv("VIDEOITG_LM_SPLASH", raising=False)
    _, model = bridged_pair(tiny_params(seed=3))
    cfg = preset("tiny")
    tok = CharTokenizer(cfg.lm.vocab_size)
    frames = np.random.default_rng(12).integers(0, 256, (6, 56, 56, 3), dtype=np.uint8)
    scores, calls = {}, {}
    for on in (False, True):
        engine = SelectionEngine(model, cfg, tok, device="cpu", dtype=torch.float32,
                                 use_flash=True, buckets=(8,), lm_splash=on)
        n = []
        real = splash_attention.splash_lm
        monkeypatch.setattr(splash_attention, "splash_lm",
                            lambda *a, _real=real, _n=n: (_n.append(1), _real(*a))[1])
        scores[on] = engine.select(frames, list(range(6)), "what happens next?").raw_scores
        monkeypatch.setattr(splash_attention, "splash_lm", real)
        calls[on] = len(n)
    assert calls == {False: 0, True: cfg.lm.num_layers}
    np.testing.assert_allclose(scores[True], scores[False], atol=2e-5, rtol=0)
    monkeypatch.setenv("VIDEOITG_LM_SPLASH", "1")
    assert SelectionEngine(model, cfg, tok, device="cpu", dtype=torch.float32).lm_splash is True
    assert SelectionEngine(model, cfg, tok, device="cpu", dtype=torch.float32,
                           lm_splash=False).lm_splash is False
