"""The port's quantisers, tiers and act8 GEMM against the JAX package.

Inputs come from numpy with a seed and go through the JAX function and its
counterpart in the port; weights cross through the bridge
(`checkpoint.params_from_numpy`). fp32 on the CPU: the port's kernel wrappers
take their plain versions there, the JAX Pallas kernel runs in interpret
mode. Integer results (quantised weights, packed nibbles) must be equal bit
for bit; float results are held to rtol = atol = 1e-6 unless a test says
otherwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.config import preset as jax_preset
from videoitg_tpu.data.video import write_test_video
from videoitg_tpu.engine import SelectionEngine as JaxEngine
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.ops import quant as jax_quant
from videoitg_tpu.ops import quant_gemm as jax_quant_gemm
from videoitg_tpu.utils.common import CharTokenizer as JaxCharTokenizer
from videoitg_tpu_torch.checkpoint import params_from_numpy, params_to_numpy
from videoitg_tpu_torch.config import preset
from videoitg_tpu_torch.engine import SelectionEngine
from videoitg_tpu_torch.models.common import Linear, fused_qkv, linear
from videoitg_tpu_torch.ops import quant, quant_gemm
from videoitg_tpu_torch.utils.common import CharTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIGHT = dict(rtol=1e-6, atol=1e-6)
TIERS = ["int8", "int4", "act8"]


def _weights(seed, *shape):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)
    w[..., :, 3] = 0.0  # a zero column: its scale must be 1
    return w


def _dense(w, b=None) -> Linear:
    lin = Linear(w.shape[0], w.shape[1], bias=b is not None)
    lin.w.data = torch.from_numpy(w)
    if b is not None:
        lin.b.data = torch.from_numpy(b)
    return lin


def _tree_equal(a, b, path=""):
    assert set(a) == set(b), (path, set(a) ^ set(b))
    for key in a:
        if isinstance(a[key], dict):
            _tree_equal(a[key], b[key], f"{path}{key}.")
        elif a[key] is None:
            assert b[key] is None, path + key
        else:
            assert a[key].dtype == b[key].dtype, (path + key, a[key].dtype, b[key].dtype)
            assert np.array_equal(a[key], b[key]), path + key


# ---- quantisers: bit for bit ----


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)], ids=["dense", "stacked"])
def test_quantize_int8_bit_for_bit(shape):
    w = _weights(0, *shape)
    want = jax_quant.quantize_linear_int8({"w": jnp.asarray(w)})
    w_q, scale = quant.quantize_weight_int8(torch.from_numpy(w))
    assert w_q.dtype == torch.int8 and scale.dtype == torch.float32
    assert np.array_equal(w_q.numpy(), np.asarray(want["w_q"]))
    assert np.array_equal(scale.numpy(), np.asarray(want["scale"]))
    assert np.all(scale.numpy()[..., 3] == 1.0)


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)], ids=["dense", "stacked"])
def test_quantize_int4_and_unpack_bit_for_bit(shape):
    w = _weights(1, *shape)
    want = jax_quant.quantize_linear_int4({"w": jnp.asarray(w)})
    packed, scale = quant.quantize_weight_int4(torch.from_numpy(w))
    assert packed.dtype == torch.int8 and packed.shape[-2] == shape[-2] // 2
    assert np.array_equal(packed.numpy(), np.asarray(want["w_q4"]))
    assert np.array_equal(scale.numpy(), np.asarray(want["scale4"]))
    unpacked = quant.unpack_int4(packed)
    assert np.array_equal(unpacked.numpy(), np.asarray(jax_quant.unpack_int4(want["w_q4"])))
    assert unpacked.min() >= -7 and unpacked.max() <= 7
    # every byte value, not only those a quantiser produces
    every = np.arange(-128, 128, dtype=np.int8).reshape(128, 2)
    assert np.array_equal(quant.unpack_int4(torch.from_numpy(every)).numpy(),
                          np.asarray(jax_quant.unpack_int4(jnp.asarray(every))))


def test_quantize_int4_needs_even_input_dim():
    with pytest.raises(ValueError, match="even"):
        quant.quantize_weight_int4(torch.zeros(5, 4))


def test_quantize_linear_modules_keep_layout_and_bias():
    w = _weights(2, 32, 24)
    b = np.random.default_rng(2).standard_normal(24).astype(np.float32)
    want = jax_quant.quantize_linear_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    q = quant.quantize_linear_int8(_dense(w, b))
    assert q.w_qt.shape == (24, 32) and q.w_qt.is_contiguous() and not q.act_q
    assert np.array_equal(q.w_q.numpy(), np.asarray(want["w_q"]))  # the [in, out] view
    assert np.array_equal(q.b.numpy(), b)
    assert (q.in_features, q.out_features) == (32, 24)
    q4 = quant.quantize_linear_int4(_dense(w))
    assert q4.bits == 4 and q4.b is None and (q4.in_features, q4.out_features) == (32, 24)
    assert quant.is_quantized(q) and quant.is_quantized(q4) and not quant.is_quantized(_dense(w))
    with pytest.raises(ValueError):
        quant.QuantLinear(w_qt=q.w_qt, w_q4=q4.w_q4, scale=q.scale)
    with pytest.raises(ValueError):
        quant.QuantLinear(w_qt=q.w_qt.float(), scale=q.scale)


def test_cast_keeps_int8_and_fp32_scales():
    w = _weights(3, 32, 24)
    b = np.ones(24, np.float32)
    for make in (quant.quantize_linear_int8, quant.quantize_linear_int4):
        q = make(_dense(w, b))
        name = "scale" if q.bits == 8 else "scale4"
        before = getattr(q, name).clone()
        q = quant.cast_params(q, torch.bfloat16)
        assert q.b.dtype == torch.bfloat16
        assert getattr(q, name).dtype == torch.float32
        assert torch.equal(getattr(q, name), before)  # not rounded through bf16
        assert (q.w_qt if q.bits == 8 else q.w_q4).dtype == torch.int8
        q = q.to(torch.float32)
        assert torch.equal(getattr(q, name), before)


# ---- quantised linears against the JAX functions ----


@pytest.mark.parametrize("form", ["int8", "int8-act", "int4", "int4-act"])
def test_quantized_linear_matches_jax(form):
    rng = np.random.default_rng(4)
    w = _weights(4, 64, 40)
    b = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    x[1, 2] = 0.0  # a zero row: activation scale 1
    jlin = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    if form.startswith("int8"):
        jq, q = jax_quant.quantize_linear_int8(jlin), quant.quantize_linear_int8(_dense(w, b))
        jax_fn = jax_quant.quantized_linear
    else:
        jq, q = jax_quant.quantize_linear_int4(jlin), quant.quantize_linear_int4(_dense(w, b))
        jax_fn = jax_quant.quantized_linear_int4
    if form.endswith("act"):
        jq["act_q"] = None
        q.act_q = True
    want = np.asarray(jax_fn(jq, jnp.asarray(x)))
    got = quant.quantized_linear(q, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TIGHT)
    np.testing.assert_allclose(linear(q, torch.from_numpy(x)).numpy(), want, **TIGHT)


def test_fused_qkv_runs_three_linears_when_quantised():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    dense = [_dense(_weights(5 + i, 32, 16), np.zeros(16, np.float32)) for i in range(3)]
    mixed = [dense[0], quant.quantize_linear_int8(dense[1]), dense[2]]
    got = fused_qkv(*mixed, x)
    for y, p in zip(got, mixed):
        np.testing.assert_allclose(y.numpy(), linear(p, x).numpy(), **TIGHT)
    for y, p in zip(fused_qkv(*dense, x), dense):
        np.testing.assert_allclose(y.numpy(), linear(p, x).numpy(), atol=1e-5, rtol=1e-5)


# ---- kernel F's plain version against the Pallas kernel (interpret) ----


def _act8_case():
    rng = np.random.default_rng(0)
    k, n, m = 512, 512, 70  # tests/test_quant.py's shape: one k/n block, m pads 70 -> 256
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    jlin = jax_quant.quantize_linear_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    jlin["act_q"] = None
    lin = quant.quantize_linear_int8(_dense(w, b))
    lin.act_q = True
    return jlin, lin, x


@pytest.mark.parametrize("zero_row", [False, True])
def test_act8_linear_matches_pallas_interpret(zero_row):
    jlin, lin, x = _act8_case()
    if zero_row:
        x[0, 0] = 0.0
    assert jax_quant_gemm.shapes_supported(jlin, None) and quant_gemm.shapes_supported(lin)
    want = np.asarray(jax_quant_gemm.act8_linear(jlin, jnp.asarray(x), interpret=True))
    got = quant_gemm.act8_linear(lin, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 35, 512)
    np.testing.assert_allclose(got, want, **TIGHT)
    # and the switch routes the same linear through it
    routed = quant.quantized_linear(lin, torch.from_numpy(x), quant.Act8Switches(qgemm=True))
    np.testing.assert_array_equal(routed.numpy(), got)
    # the library-product arm agrees with the kernel's plain version
    np.testing.assert_allclose(quant.quantized_linear(lin, torch.from_numpy(x)).numpy(), got,
                               **TIGHT)


def test_act8_gemm_reference_is_the_formula():
    _, lin, x = _act8_case()
    x2 = torch.from_numpy(x.reshape(-1, 512))
    xs = quant_gemm.row_scale(x2)
    np.testing.assert_array_equal(xs.numpy(), (np.abs(x2.numpy()).max(-1, keepdims=True)
                                               / np.float32(127.0)))
    x_q = np.clip(np.round(x2.numpy() / xs.numpy()), -127, 127).astype(np.int64)
    acc = x_q @ lin.w_q.numpy().astype(np.int64)
    want = acc.astype(np.float32) * xs.numpy() * lin.scale.numpy()
    got = quant_gemm.act8_gemm(x2, xs, lin.w_qt, lin.scale).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,n,ok", [(512, 512, True), (1024, 1536, True), (1152, 1152, False),
                                    (512, 500, False), (64, 64, False)])
def test_shapes_supported_follows_the_jax_rule(k, n, ok):
    w = np.zeros((k, n), np.float32)
    jlin = jax_quant.quantize_linear_int8({"w": jnp.asarray(w)})
    lin = quant.quantize_linear_int8(_dense(w))
    assert jax_quant_gemm.shapes_supported(jlin, None) == ok
    assert quant_gemm.shapes_supported(lin) == ok
    assert not quant_gemm.shapes_supported(_dense(w))
    assert not quant_gemm.shapes_supported(quant.quantize_linear_int4(_dense(w)))


def test_switches_read_the_environment_once(monkeypatch):
    monkeypatch.delenv("VIDEOITG_QGEMM", raising=False)
    monkeypatch.delenv("VIDEOITG_FUSED", raising=False)
    assert quant.Act8Switches.from_env() == quant.Act8Switches(False, False)
    monkeypatch.setenv("VIDEOITG_QGEMM", "1")
    monkeypatch.setenv("VIDEOITG_FUSED", "0")
    assert quant.Act8Switches.from_env() == quant.Act8Switches(True, False)
    assert quant.Act8Switches.from_env(qgemm=False, fused=True) == quant.Act8Switches(False, True)


# ---- tiers, the bridge and the slice as a whole ----


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_preset("tiny")
    params = jax_init_grounding(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, preset("tiny"), params


@pytest.mark.parametrize("tier", TIERS)
def test_bridge_round_trips_quantised_trees_bit_for_bit(tiny, tier):
    _, cfg, params = tiny
    tree = jax.tree.map(np.asarray, jax_quant.apply_quantization_tier(params, tier))
    model = params_from_numpy(tree, cfg)
    assert quant.is_quantized_tree(model)
    back = params_to_numpy(model)
    _tree_equal(tree, back)
    key = "w_q4" if tier == "int4" else "w_q"
    assert back["lm"]["layers"]["q"][key].dtype == np.int8
    assert ("act_q" in back["lm"]["layers"]["q"]) == (tier == "act8")
    assert ("w_q" in back["vision"]["layers"]["fc1"]) == (tier == "act8")


@pytest.mark.parametrize("tier", TIERS)
def test_port_tier_transform_equals_jax_tier_transform(tiny, tier):
    """Quantising in the port gives the tree that quantising in JAX gives."""
    _, cfg, params = tiny
    want = jax.tree.map(np.asarray, jax_quant.apply_quantization_tier(params, tier))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    assert not quant.is_quantized_tree(model)
    model = quant.apply_quantization_tier(model, tier)
    _tree_equal(want, params_to_numpy(model))


def test_unknown_tier_and_lora_are_refused(tiny):
    _, cfg, params = tiny
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    with pytest.raises(ValueError, match="unknown quantization tier"):
        quant.apply_quantization_tier(model, "int2")
    # A LoRA tree crosses the bridge (tests/test_torch_lora.py); an adapter
    # with a leaf missing is refused.
    tree = jax.tree.map(np.asarray, params)
    tree["lm"]["layers"]["q"] = dict(tree["lm"]["layers"]["q"], lora_a=np.zeros((2, 4, 2)))
    with pytest.raises(KeyError, match="LoRA adapter holds"):
        params_from_numpy(tree, cfg)


# Weight-only tiers differ from JAX only by fp32 summation order (the dense
# path holds 2e-5). Under act8 the same tiny differences can flip the int8
# rounding of an activation that sits on a rounding boundary: over 8 (weights,
# frames) seeds the sigmoid scores agreed to 1.2e-7 in 6 and differed by
# 2.5e-3 and 3.4e-3 in 2. Frames seed 0 has no flip and is held to 2e-5; seed
# 11 has one (1.3e-3 measured) and is held to 1e-2, a tenth of the spread of
# the scores over the frames.
SLICE_CASES = [("int8", 11, 2e-5), ("int4", 11, 2e-5), ("act8", 0, 2e-5), ("act8", 11, 1e-2)]


@pytest.mark.parametrize("tier,frames_seed,atol", SLICE_CASES)
def test_score_frames_matches_jax_engine_per_tier(tiny, tier, frames_seed, atol):
    jcfg, cfg, params = tiny
    qparams = jax_quant.apply_quantization_tier(params, tier)
    model = params_from_numpy(jax.tree.map(np.asarray, qparams), cfg)
    kw = dict(buckets=(4, 8), num_frames=8)
    jax_engine = JaxEngine(qparams, jcfg, JaxCharTokenizer(jcfg.lm.vocab_size),
                           dtype=jnp.float32, use_flash=False, **kw)
    port = SelectionEngine(model, cfg, CharTokenizer(cfg.lm.vocab_size), device="cpu",
                           dtype=torch.float32, use_flash=False, **kw)
    rng = np.random.default_rng(frames_seed)
    frames = rng.integers(0, 256, (6, 56, 56, 3), dtype=np.uint8)
    want = jax_engine.score_frames([frames], ["what happens next?"])[0]
    got = port.score_frames([frames], ["what happens next?"])[0]
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    # both int8 switches on: the tiny shapes are outside F's rule and the CPU
    # takes the plain versions of G, H, I; the scores stay within the bound.
    switched = SelectionEngine(model, cfg, CharTokenizer(cfg.lm.vocab_size), device="cpu",
                               dtype=torch.float32, use_flash=True, qgemm=True, fused=True, **kw)
    np.testing.assert_allclose(switched.score_frames([frames], ["what happens next?"])[0],
                               want, atol=1e-2, rtol=0)


def test_init_qwen2_quantized_forms():
    cfg = preset("tiny").lm
    gen = torch.Generator().manual_seed(0)
    lm8 = quant.init_qwen2_int8(cfg, gen, dtype=torch.float32)
    lm4 = quant.init_qwen2_int4(cfg, gen, dtype=torch.float32)
    for lm, bits, scale in ((lm8, 8, 0.01), (lm4, 4, 0.02)):
        layer = lm.layers[0]
        for key in quant.QWEN2_LINEAR_KEYS:
            lin = getattr(layer, key)
            assert isinstance(lin, quant.QuantLinear) and lin.bits == bits
            assert (lin.b is not None) == (key in ("q", "k", "v"))
            s = lin.scale if bits == 8 else lin.scale4
            assert torch.all(s == scale) and s.dtype == torch.float32
        assert (layer.q.in_features, layer.q.out_features) == (cfg.hidden_size, cfg.q_dim)
        assert (layer.down.in_features, layer.down.out_features) == (
            cfg.intermediate_size, cfg.hidden_size)
    assert lm8.layers[0].gate.w_qt.abs().max() <= 127
    from videoitg_tpu_torch.models.qwen2 import qwen2_hidden_states

    x = torch.randn(1, 5, cfg.hidden_size, generator=gen)
    pos = torch.arange(5)[None]
    for lm in (lm8, lm4):
        out = qwen2_hidden_states(lm, x, pos, None, cfg)
        assert out.shape == x.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("tier", TIERS)
def test_cli_select_quantize_in_a_child_process(tmp_path, tier):
    path = write_test_video(str(tmp_path / "v.mp4"), 100, 76, 20, 10, 8)
    env = dict(os.environ, PYTHONPATH=REPO, VIDEOITG_QGEMM="1", VIDEOITG_FUSED="1")
    proc = subprocess.run(
        [sys.executable, "-m", "videoitg_tpu_torch.cli.select", "--preset", "tiny",
         "--random-init", "--quantize", tier, "--video", path, "--prompt", "what?",
         "--device", "cpu", "--num-frames", "8", "--target-fps", "10", "--json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(record["index"]) == sorted(set(record["index"])) and len(record["index"]) == 8
    assert all(0.0 <= v <= 1.0 for v in record["logits"])
