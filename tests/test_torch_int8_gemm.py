"""The decomposition behind the Hopper int8 GEMM kernels F, G, H and I, on
the CPU.

Every product runs on the TMA + s8 wgmma GEMM with an epilogue policy, after
a row quantisation launch. Kernel F (`act8_gemm`) is two launches: a row
quantisation of x, then the GEMM with `Act8Out`. Kernel G
(`fused_ln_qkv_int8`) is two: LN + row quantisation, then the packed QKV
product with `QkvOut`, split into q, k, v. Kernel H (`fused_ln_mlp_int8`)
is four: G's first launch, fc1 with a per-row amax epilogue reduced over the
GEMM's n tiles, fc1 again quantised with the full row's scale, and fc2 with
bias and residual. Kernel I (`fused_proj_residual_int8`) is two: F's row
quantisation, then o_proj with bias and residual. Each launch has a plain
PyTorch version beside its wrapper; here their composition is held bit for
bit to the one-piece plain versions and within the JAX tests' own bound to
the JAX package's Pallas kernels in interpret mode. Inputs come from numpy
with a seed; fp32 on the CPU.

Also here: every C entry point of csrc/ has a `_build.SIGNATURES` row of its
arity, and the request profile's grouping puts each kernel's instances in
one group: its own, or the shared row quantisation's.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoitg_tpu.ops import fused_encoder as jax_fused
from videoitg_tpu.ops import quant as jax_quant
from videoitg_tpu.ops import quant_gemm as jax_quant_gemm
from videoitg_tpu_torch.models.common import Norm
from videoitg_tpu_torch.ops import _build
from videoitg_tpu_torch.ops import fused_encoder as fused
from videoitg_tpu_torch.ops import quant_gemm
from videoitg_tpu_torch.ops.quant import QuantLinear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-6


def _tol(ref) -> float:
    """The JAX tests' bound for the fused int8 kernels (tests/test_fused_encoder.py)."""
    return 4.0 * float(np.max(np.abs(ref))) / 127.0 + 1e-5


def _mk_lin(rng, d_in, d_out, bias=True):
    """The same int8 + act_q linear in both forms (quantised by JAX)."""
    lin = {"w": jnp.asarray(rng.standard_normal((d_in, d_out)) * d_in ** -0.5, jnp.float32)}
    if bias:
        lin["b"] = jnp.asarray(rng.standard_normal(d_out) * 0.3, jnp.float32)
    jq = jax_quant.quantize_linear_int8(lin)
    jq["act_q"] = None
    q = QuantLinear(w_qt=torch.from_numpy(np.asarray(jq["w_q"]).T.copy()),
                    scale=torch.from_numpy(np.asarray(jq["scale"]).copy()),
                    b=torch.from_numpy(np.asarray(jq["b"]).copy()) if bias else None,
                    act_q=True)
    return jq, q


def _mk_ln(rng, h, bias=True):
    scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h) if bias else np.zeros(h)).astype(np.float32)
    norm = Norm(h, bias=True)
    norm.scale.data = torch.from_numpy(scale)
    norm.bias.data = torch.from_numpy(b)
    return {"scale": jnp.asarray(scale), "bias": jnp.asarray(b)}, norm


# ---- H: LN-quant -> fc1 amax per n tile -> fc1 quantised -> fc2 + residual ----

# rows not a multiple of the GEMM's 128-row tile; an intermediate width that
# is no multiple of its 256-column tile (as 4304 is not), and one that is
H_CASES = [
    pytest.param(300, 64, 304, False, id="ragged-rows-ragged-tile"),
    pytest.param(130, 64, 512, False, id="two-whole-tiles"),
    pytest.param(200, 48, 304, True, id="zero-row"),
]


def _h_case(rows, h, m, zero_row, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, h)) * 2.0).astype(np.float32)
    jln, ln = _mk_ln(rng, h, bias=not zero_row)
    (j1, fc1), (j2, fc2) = _mk_lin(rng, h, m, bias=not zero_row), _mk_lin(rng, m, h)
    if not zero_row:
        # the last 16 channels hot, as in the card's check: the tile that
        # holds them sets the row's amax
        fc1.b[-16:] += 4.0
        j1["b"] = j1["b"].at[-16:].add(4.0)
    else:
        x[5] = 0.0
    return x, jln, ln, j1, fc1, j2, fc2


@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu"])
@pytest.mark.parametrize("rows,h,m,zero_row", H_CASES)
def test_mlp_stages_compose_to_the_reference_bit_for_bit(rows, h, m, zero_row, act):
    x, _, ln, _, fc1, _, fc2 = _h_case(rows, h, m, zero_row, seed=20)
    xt = torch.from_numpy(x)
    yq, ys = fused.ln_row_quant(xt, ln, EPS)
    assert yq.dtype == torch.int8 and yq.shape == (rows, h) and ys.shape == (rows, 1)
    amax = fused.mlp_fc1_amax(yq, ys, fc1, act)
    assert amax.shape == (rows,) and amax.dtype == torch.float32
    gq = fused.mlp_fc1_quant(yq, ys, fc1, amax, act)
    assert gq.dtype == torch.int8 and gq.shape == (rows, m)
    out = fused.mlp_fc2_residual(xt, gq, amax, fc2)
    want = fused.fused_ln_mlp_int8_reference(xt, ln, fc1, fc2, EPS, act)
    assert torch.equal(out, want)
    # the per-tile amax, max-reduced over the tiles, is the row's amax
    g = fused._fc1_act(yq, ys, fc1, act)
    assert torch.equal(amax, g.abs().amax(dim=-1))
    # the whole row's scale reaches +-127 somewhere in every row with a value
    nonzero = amax > 0
    assert torch.equal(gq.abs().amax(dim=-1)[nonzero], torch.full_like(
        gq[nonzero, 0], 127))
    if zero_row:
        assert yq[5].abs().max() == 0 and ys[5].item() == 1.0
        assert amax[5].item() == 0.0 and gq[5].abs().max() == 0
        torch.testing.assert_close(out[5], fc2.b.float(), rtol=0, atol=0)


@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu"])
@pytest.mark.parametrize("rows,h,m,zero_row", H_CASES)
def test_mlp_stages_match_the_pallas_kernel(rows, h, m, zero_row, act):
    x, jln, ln, j1, fc1, j2, fc2 = _h_case(rows, h, m, zero_row, seed=21)
    want = np.asarray(jax_fused.fused_ln_mlp_int8(jnp.asarray(x), jln, j1, j2, EPS, act=act,
                                                  interpret=True))
    xt = torch.from_numpy(x)
    yq, ys = fused.ln_row_quant(xt, ln, EPS)
    amax = fused.mlp_fc1_amax(yq, ys, fc1, act)
    got = fused.mlp_fc2_residual(xt, fused.mlp_fc1_quant(yq, ys, fc1, amax, act), amax,
                                 fc2).numpy()
    np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)
    # a flip moves few values: most of the output agrees to fp32 noise
    assert np.mean(~np.isclose(got, want, rtol=2e-5, atol=2e-5)) < 0.05


def test_mlp_amax_of_one_tile_or_of_padded_columns_is_caught():
    """What the two faults the kernel's fc1 epilogues guard against would do:
    an amax from the first n tile only (the hot channels lie in the last),
    and the padded columns of fc1's last tile let in with a large bias. Both
    move the output beyond the bound the correct stages stay within."""
    rows, h, m, act = 300, 64, 304, "gelu_tanh"
    x, _, ln, _, fc1, _, fc2 = _h_case(rows, h, m, False, seed=22)
    fc1.b[-16:] += 28.0
    xt = torch.from_numpy(x)
    want = fused.fused_ln_mlp_int8_reference(xt, ln, fc1, fc2, EPS, act).numpy()
    tol = _tol(want)
    yq, ys = fused.ln_row_quant(xt, ln, EPS)
    amax = fused.mlp_fc1_amax(yq, ys, fc1, act)
    good = fused.mlp_fc2_residual(xt, fused.mlp_fc1_quant(yq, ys, fc1, amax, act), amax, fc2)
    assert np.abs(good.numpy() - want).max() == 0.0
    first = QuantLinear(w_qt=fc1.w_qt[:fused.FC1_TILE], scale=fc1.scale[:fused.FC1_TILE],
                        b=fc1.b[:fused.FC1_TILE], act_q=True)
    one_tile = fused.mlp_fc1_amax(yq, ys, first, act)
    bad = fused.mlp_fc2_residual(xt, fused.mlp_fc1_quant(yq, ys, fc1, one_tile, act),
                                 one_tile, fc2)
    assert np.abs(bad.numpy() - want).max() > tol
    pad = 2 * fused.FC1_TILE - m
    padded = QuantLinear(w_qt=torch.cat([fc1.w_qt, fc1.w_qt.new_zeros(pad, h)]),
                         scale=torch.cat([fc1.scale, fc1.scale.new_ones(pad)]),
                         b=torch.cat([fc1.b, fc1.b.new_full((pad,), 1024.0)]), act_q=True)
    counted = fused.mlp_fc1_amax(yq, ys, padded, act)
    bad = fused.mlp_fc2_residual(xt, fused.mlp_fc1_quant(yq, ys, fc1, counted, act), counted,
                                 fc2)
    assert np.abs(bad.numpy() - want).max() > tol


# ---- F: row quantisation -> GEMM with the Act8Out epilogue ----


@pytest.mark.parametrize("m,zero_row", [(35, False), (130, True), (1, False)])
def test_act8_quantise_then_gemm_is_the_reference_bit_for_bit(m, zero_row):
    rng = np.random.default_rng(23)
    k, n = 512, 512
    x = (rng.standard_normal((m, k)) * np.exp(rng.standard_normal((m, 1)))).astype(np.float32)
    if zero_row:
        x[3] = 0.0
    jlin, lin = _mk_lin(rng, k, n, bias=False)
    xt = torch.from_numpy(x)
    x_q, x_scale = quant_gemm.row_quant_reference(xt)
    assert x_q.dtype == torch.int8 and x_scale.shape == (m, 1)
    got = quant_gemm.act8_gemm_s8_reference(x_q, x_scale, lin.w_qt, lin.scale, xt.dtype)
    # the row scale made inside equals the one made outside, and so does the result
    assert torch.equal(got, quant_gemm.act8_gemm_reference(xt, None, lin.w_qt, lin.scale))
    assert torch.equal(got, quant_gemm.act8_gemm(xt, quant_gemm.row_scale(xt), lin.w_qt,
                                                 lin.scale))
    assert torch.equal(got, quant_gemm.act8_gemm(xt, None, lin.w_qt, lin.scale))
    # the formula in numpy, exact integer product
    xs = np.abs(x).max(-1, keepdims=True) / np.float32(127.0)
    xs = np.where(xs == 0, np.float32(1.0), xs).astype(np.float32)
    np.testing.assert_array_equal(x_scale.numpy(), xs)
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int64)
    np.testing.assert_array_equal(x_q.numpy(), xq)
    acc = xq @ lin.w_qt.numpy().T.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32) * xs * lin.scale.numpy())
    if zero_row:
        assert x_scale[3].item() == 1.0 and got[3].abs().max() == 0
    # and the JAX package's Pallas kernel (interpret mode) on the same linear
    want = np.asarray(jax_quant_gemm.act8_linear(jlin, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---- G: LN-quant -> packed QKV product with the QkvOut epilogue, split ----

# A 256-column tile of the packed product crossing q|k and k|v (136 + 64 +
# 200 = 400 columns: the first tile holds all of q, all of k and the start
# of v); ragged rows; a zero row; widths no multiple of 16 and no biases.
G_CASES = [
    pytest.param(300, 64, (136, 64, 200), False, True, id="tile-crosses-q-k-and-k-v"),
    pytest.param(130, 64, (64, 64, 64), True, True, id="zero-row"),
    pytest.param(77, 48, (48, 16, 24), False, False, id="narrow-no-bias"),
]


def _g_case(rows, h, widths, zero_row, bias, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, h)) * 2.0).astype(np.float32)
    if zero_row:
        x[5] = 0.0
    jln, ln = _mk_ln(rng, h, bias=not zero_row)
    lins = [_mk_lin(rng, h, d, bias=bias) for d in widths]
    return x, jln, ln, lins


@pytest.mark.parametrize("rows,h,widths,zero_row,bias", G_CASES)
def test_qkv_stages_compose_to_the_reference_bit_for_bit(rows, h, widths, zero_row, bias):
    x, _, ln, lins = _g_case(rows, h, widths, zero_row, bias, seed=24)
    xt = torch.from_numpy(x)
    q_lin, k_lin, v_lin = (q for _, q in lins)
    yq, ys = fused.ln_row_quant(xt, ln, EPS)
    assert yq.dtype == torch.int8 and yq.shape == (rows, h) and ys.shape == (rows, 1)
    out = fused.qkv_project(yq, ys, q_lin, k_lin, v_lin, dtype=xt.dtype)
    want = fused.fused_ln_qkv_int8_reference(xt, ln, q_lin, k_lin, v_lin, EPS)
    assert [o.shape for o in out] == [(rows, d) for d in widths]
    for got, ref in zip(out, want):
        assert got.is_contiguous() and torch.equal(got, ref)
    if zero_row:
        # LN of a zero row is its bias, here 0: the row quantises to zeros
        # with scale 1, and each output row is its linear's bias
        assert yq[5].abs().max() == 0 and ys[5].item() == 1.0
        for got, lin in zip(out, (q_lin, k_lin, v_lin)):
            torch.testing.assert_close(got[5], lin.b.float(), rtol=0, atol=0)


@pytest.mark.parametrize("rows,h,widths,zero_row,bias", G_CASES)
def test_qkv_stages_match_the_pallas_kernel(rows, h, widths, zero_row, bias):
    x, jln, ln, lins = _g_case(rows, h, widths, zero_row, bias, seed=25)
    want = jax_fused.fused_ln_qkv_int8(jnp.asarray(x), jln, *(j for j, _ in lins), EPS,
                                       interpret=True)
    xt = torch.from_numpy(x)
    yq, ys = fused.ln_row_quant(xt, ln, EPS)
    got = fused.qkv_project(yq, ys, *(q for _, q in lins), dtype=xt.dtype)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=_tol(w), rtol=0)
        # a flip moves few values: most of the output agrees to fp32 noise
        assert np.mean(~np.isclose(g.numpy(), w, rtol=2e-5, atol=2e-5)) < 0.05


def test_qkv_split_at_a_wrong_offset_is_caught():
    """What a wrong split of the packed product would give: k read as q, and
    every output shifted by one chunk of 8 columns. Both move the output
    beyond the bound the correct split stays within."""
    rows, h, widths = 300, 64, (136, 64, 200)
    x, _, ln, lins = _g_case(rows, h, widths, False, True, seed=26)
    xt = torch.from_numpy(x)
    q_lin, k_lin, v_lin = (q for _, q in lins)
    want = fused.fused_ln_qkv_int8_reference(xt, ln, q_lin, k_lin, v_lin, EPS)
    tol = min(_tol(w.numpy()) for w in want)
    yq, ys = fused.ln_row_quant(xt, ln, EPS)
    q, k, v = fused.qkv_project(yq, ys, q_lin, k_lin, v_lin, dtype=xt.dtype)
    assert np.abs(k.numpy() - want[0][:, :64].numpy()).max() > tol
    w, s, b = fused._packed_qkv(q_lin, k_lin, v_lin, yq.device)
    packed = fused._scaled(fused.int8_matmul(yq, w), ys, s, b)
    shifted = packed[:, 8:8 + 136]
    assert np.abs(shifted.numpy() - q.numpy()).max() > tol
    assert torch.equal(packed[:, 136:200], k) and torch.equal(packed[:, 200:], v)


# ---- I: row quantisation (F's first launch) -> o_proj with BiasResidual ----

I_CASES = [
    pytest.param(300, 64, 64, False, True, id="ragged-rows"),
    pytest.param(130, 48, 136, True, True, id="zero-row"),
    pytest.param(1, 32, 24, False, False, id="one-row-no-bias"),
]


def _i_case(rows, d, h, zero_row, bias, seed):
    rng = np.random.default_rng(seed)
    attn = (rng.standard_normal((rows, d)) * np.exp(rng.standard_normal((rows, 1)))).astype(
        np.float32)
    if zero_row:
        attn[3] = 0.0
    res = rng.standard_normal((rows, h)).astype(np.float32)
    jo, o_lin = _mk_lin(rng, d, h, bias=bias)
    return attn, res, jo, o_lin


@pytest.mark.parametrize("rows,d,h,zero_row,bias", I_CASES)
def test_proj_stages_compose_to_the_reference_bit_for_bit(rows, d, h, zero_row, bias):
    attn, res, _, o_lin = _i_case(rows, d, h, zero_row, bias, seed=27)
    at, rt = torch.from_numpy(attn), torch.from_numpy(res)
    aq, a_scale = quant_gemm.row_quant_int8(at)
    assert aq.dtype == torch.int8 and aq.shape == (rows, d) and a_scale.shape == (rows, 1)
    got = fused.proj_residual(aq, a_scale, rt, o_lin)
    assert torch.equal(got, fused.fused_proj_residual_int8_reference(at, rt, o_lin))
    # F's row quantisation is the same quantiser as the one-piece plain version's
    want_q, want_s = fused.row_quant(at.float())
    assert torch.equal(aq, want_q) and torch.equal(a_scale, want_s)
    if zero_row:
        assert aq[3].abs().max() == 0 and a_scale[3].item() == 1.0
        torch.testing.assert_close(got[3], rt[3] + o_lin.b, rtol=0, atol=0)


@pytest.mark.parametrize("rows,d,h,zero_row,bias", I_CASES)
def test_proj_stages_match_the_pallas_kernel(rows, d, h, zero_row, bias):
    attn, res, jo, o_lin = _i_case(rows, d, h, zero_row, bias, seed=28)
    want = np.asarray(jax_fused.fused_proj_residual_int8(jnp.asarray(attn), jnp.asarray(res), jo,
                                                         interpret=True))
    aq, a_scale = quant_gemm.row_quant_int8(torch.from_numpy(attn))
    got = fused.proj_residual(aq, a_scale, torch.from_numpy(res), o_lin).numpy()
    np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)
    # no LN before the quantiser: nothing flips, fp32 noise only
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ---- the C entry points and the profile's groups ----


def _entry_points():
    """name -> parameter count of every `extern "C" int` function in csrc/."""
    found = {}
    for path in _build.sources():
        with open(path) as f:
            text = f.read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_every_entry_point_has_a_signature_of_its_arity():
    found = _entry_points()
    for name in ("videoitg_row_quant_int8_bf16", "videoitg_act8_gemm_s8",
                 "videoitg_ln_row_quant_int8_bf16", "videoitg_qkv_gemm_s8",
                 "videoitg_mlp_fc1_amax_s8", "videoitg_mlp_fc1_quant_s8",
                 "videoitg_mlp_fc2_residual_s8", "videoitg_proj_residual_s8"):
        assert name in found, name
    assert set(found) == set(_build.SIGNATURES)
    for name, arity in found.items():
        assert len(_build.SIGNATURES[name]) == arity, name
    # the one-launch entry points of the mma.sync versions are gone, and the
    # LN + quantise launch is named for what it does, not for H
    for gone in ("videoitg_act8_gemm_bf16", "videoitg_fused_ln_mlp_int8_bf16",
                 "videoitg_fused_ln_qkv_int8_bf16", "videoitg_fused_proj_residual_int8_bf16",
                 "videoitg_mlp_ln_quant_int8_bf16"):
        assert gone not in found, gone


def _group_of():
    spec = importlib.util.spec_from_file_location(
        "torch_profile_request", os.path.join(REPO, "scripts", "torch_profile_request.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.group_of


# Demangled names of each kernel's launches as torch.profiler reports them.
# The two row quantisers serve two kernels each (F and I, G and H): they
# have a group of their own.
QUANT_GROUP = "int8 row quantisation (F, G, H, I)"
ROW_QUANT = ("void videoitg::row_quant_kernel(__nv_bfloat16 const*, float*, signed char*, int, "
             "int)")
LN_QUANT = ("void videoitg::ln_quant_kernel(__nv_bfloat16 const*, float const*, float const*, "
            "signed char*, float*, int, int, float)")


def _gemm(policy: str) -> str:
    return (f"void videoitg::hgemm::gemm_kernel<{policy}>(CUtensorMap_st, CUtensorMap_st, "
            f"{policy.rstrip(' ')}, int, int, int)")


F_NAMES = [ROW_QUANT, _gemm("videoitg::Act8Out")]
G_NAMES = [LN_QUANT, _gemm("videoitg::QkvOut")]
H_NAMES = [LN_QUANT, _gemm("videoitg::RowAmax<0> "), _gemm("videoitg::QuantStore<1> "),
           _gemm("videoitg::BiasResidual<videoitg::ScaleOfAmax> ")]
I_NAMES = [ROW_QUANT, _gemm("videoitg::BiasResidual<videoitg::ScaleGiven> ")]


def _want(name: str, group: str) -> str:
    return QUANT_GROUP if name in (ROW_QUANT, LN_QUANT) else group


@pytest.mark.parametrize("name", F_NAMES)
def test_profile_groups_put_f_instances_in_f(name):
    group_of = _group_of()
    assert group_of(name) == _want(name, "kernel F act8_gemm")


@pytest.mark.parametrize("name", G_NAMES)
def test_profile_groups_put_g_instances_in_g(name):
    group_of = _group_of()
    assert group_of(name) == _want(name, "kernel G fused_ln_qkv_int8")


@pytest.mark.parametrize("name", H_NAMES)
def test_profile_groups_put_h_instances_in_h(name):
    group_of = _group_of()
    assert group_of(name) == _want(name, "kernel H fused_ln_mlp_int8")


@pytest.mark.parametrize("name", I_NAMES)
def test_profile_groups_put_i_instances_in_i(name):
    group_of = _group_of()
    assert group_of(name) == _want(name, "kernel I fused_proj_residual_int8")


def test_profile_groups_keep_library_gemms_and_g_i():
    group_of = _group_of()
    assert group_of("sm90_xmma_gemm_s8s8_s32_tn_n") == "library GEMMs"
    assert group_of("cutlass_80_tensorop_s16816gemm") == "library GEMMs"
    # every launch of the four kernels in exactly one group, none of them the
    # library's ("gemm" is in every GEMM instance's name)
    groups = {name: group_of(name) for name in F_NAMES + G_NAMES + H_NAMES + I_NAMES}
    assert set(groups.values()) == {QUANT_GROUP, "kernel F act8_gemm",
                                    "kernel G fused_ln_qkv_int8", "kernel H fused_ln_mlp_int8",
                                    "kernel I fused_proj_residual_int8"}
    # the mma.sync kernels of G and I are gone, and with them their groups
    assert group_of("void videoitg::ln_qkv_kernel(...)") == group_of("void other(...)")
    assert group_of("void videoitg::proj_res_kernel(...)") == group_of("void other(...)")
