"""The plain versions of the fused int8 encoder kernels against the JAX
package's Pallas kernels (interpret mode), and the act8 tower through them.

Inputs and weights come from numpy with a seed; the int8 weights are
quantised by the JAX package and cross as numpy arrays. fp32 on the CPU,
where the port's wrappers take their plain versions.

Tolerances. Where no int8 rounding flips, both sides do the same fp32
arithmetic and differ only by the order of the LN sums and the tanh / exp
implementation: TIGHT (rtol 2e-5, atol 2e-5, of outputs of magnitude ~1-5).
A value that sits on a rounding boundary can flip, which moves an output by
one int8 step of its row: those cases are held to the JAX tests' own bound
`_tol` = 4 max|ref| / 127 + 1e-5, never looser, and the test reports which
applied.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.config import VisionConfig as JaxVisionConfig
from videoitg_tpu.models.siglip import init_siglip as jax_init_siglip
from videoitg_tpu.models.siglip import siglip_features as jax_siglip_features
from videoitg_tpu.ops import fused_encoder as jax_fused
from videoitg_tpu.ops import quant as jax_quant
from videoitg_tpu_torch.config import VisionConfig
from videoitg_tpu_torch.models.common import Linear, Norm
from videoitg_tpu_torch.models.siglip import SiglipTower, siglip_features
from videoitg_tpu_torch.ops import fused_encoder as fused
from videoitg_tpu_torch.ops.quant import Act8Switches, QuantLinear

EPS = 1e-6
TIGHT = dict(rtol=2e-5, atol=2e-5)


def _tol(ref) -> float:
    return 4.0 * float(np.max(np.abs(ref))) / 127.0 + 1e-5


def _mk_lin(rng, d_in, d_out, bias=True):
    """The same int8 + act_q linear in both forms (quantised by JAX)."""
    lin = {"w": jnp.asarray(rng.standard_normal((d_in, d_out)) * d_in ** -0.5, jnp.float32)}
    if bias:
        lin["b"] = jnp.asarray(rng.standard_normal(d_out) * 0.02, jnp.float32)
    jq = jax_quant.quantize_linear_int8(lin)
    jq["act_q"] = None
    q = QuantLinear(w_qt=torch.from_numpy(np.asarray(jq["w_q"]).T.copy()),
                    scale=torch.from_numpy(np.asarray(jq["scale"]).copy()),
                    b=torch.from_numpy(np.asarray(jq["b"]).copy()) if bias else None,
                    act_q=True)
    return jq, q


def _mk_ln(rng, h):
    scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(h)).astype(np.float32)
    norm = Norm(h, bias=True)
    norm.scale.data = torch.from_numpy(scale)
    norm.bias.data = torch.from_numpy(bias)
    return {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, norm


def _close(got, want, what):
    """TIGHT where no rounding flipped, else within `_tol`; returns which."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if np.allclose(got, want, **TIGHT):
        return "tight"
    np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0, err_msg=what)
    # a flip moves few values: most of the tensor still agrees tightly
    assert np.mean(~np.isclose(got, want, **TIGHT)) < 0.05, what
    return "flips"


@pytest.mark.parametrize("n", [128, 300, 4])
def test_fused_ln_qkv_reference_matches_pallas(n):
    h, d = 64, 32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, h)).astype(np.float32)
    jln, ln = _mk_ln(rng, h)
    lins = [_mk_lin(rng, h, d) for _ in range(3)]
    want = jax_fused.fused_ln_qkv_int8(jnp.asarray(x), jln, *(j for j, _ in lins), EPS,
                                       interpret=True)
    got = fused.fused_ln_qkv_int8(torch.from_numpy(x), ln, *(q for _, q in lins), EPS)
    assert len(got) == 3
    for g, w, name in zip(got, want, "qkv"):
        _close(g.numpy(), w, f"{name} n={n}")


@pytest.mark.parametrize("bias", [True, False])
def test_fused_ln_qkv_uneven_widths_and_missing_bias(bias):
    h = 64
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, h)).astype(np.float32)
    jln, ln = _mk_ln(rng, h)
    lins = [_mk_lin(rng, h, d, bias=bias) for d in (48, 16, 24)]
    want = jax_fused.fused_ln_qkv_int8(jnp.asarray(x), jln, *(j for j, _ in lins), EPS,
                                       interpret=True)
    got = fused.fused_ln_qkv_int8(torch.from_numpy(x), ln, *(q for _, q in lins), EPS)
    assert [g.shape[1] for g in got] == [48, 16, 24]
    for g, w in zip(got, want):
        _close(g.numpy(), w, "uneven")


@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu"])
def test_fused_ln_mlp_reference_matches_pallas(act):
    n, h, m = 160, 64, 96
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, h)).astype(np.float32)
    jln, ln = _mk_ln(rng, h)
    (j1, fc1), (j2, fc2) = _mk_lin(rng, h, m), _mk_lin(rng, m, h)
    want = jax_fused.fused_ln_mlp_int8(jnp.asarray(x), jln, j1, j2, EPS, act=act, interpret=True)
    got = fused.fused_ln_mlp_int8(torch.from_numpy(x), ln, fc1, fc2, EPS, act=act)
    _close(got.numpy(), want, act)
    with pytest.raises(ValueError, match="activation"):
        fused.fused_ln_mlp_int8(torch.from_numpy(x), ln, fc1, fc2, EPS, act="relu")


def test_fused_proj_residual_reference_matches_pallas():
    n, d, h = 96, 48, 64
    rng = np.random.default_rng(3)
    attn = rng.standard_normal((n, d)).astype(np.float32)
    res = rng.standard_normal((n, h)).astype(np.float32)
    jo, o_lin = _mk_lin(rng, d, h)
    want = jax_fused.fused_proj_residual_int8(jnp.asarray(attn), jnp.asarray(res), jo,
                                              interpret=True)
    got = fused.fused_proj_residual_int8(torch.from_numpy(attn), torch.from_numpy(res), o_lin)
    assert _close(got.numpy(), want, "proj") == "tight"  # no LN: nothing can flip


def test_zero_rows_quantise_with_scale_one():
    rng = np.random.default_rng(4)
    attn = rng.standard_normal((8, 32)).astype(np.float32)
    attn[3] = 0.0
    res = rng.standard_normal((8, 16)).astype(np.float32)
    jo, o_lin = _mk_lin(rng, 32, 16)
    got = fused.fused_proj_residual_int8(torch.from_numpy(attn), torch.from_numpy(res), o_lin)
    want = jax_fused.fused_proj_residual_int8(jnp.asarray(attn), jnp.asarray(res), jo,
                                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    np.testing.assert_allclose(got.numpy()[3], res[3] + np.asarray(jo["b"]), **TIGHT)


def test_wrappers_refuse_dense_linears():
    _, ln = _mk_ln(np.random.default_rng(5), 16)
    dense = Linear(16, 16)
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="int8"):
        fused.fused_ln_qkv_int8(x, ln, dense, dense, dense, EPS)
    with pytest.raises(ValueError, match="int8"):
        fused.fused_proj_residual_int8(x, x, dense)


@pytest.mark.parametrize("case", ["act8", "weight-only", "dense", "int4"])
def test_can_fuse_gate(case):
    rng = np.random.default_rng(6)
    keys = ("q", "k", "v", "o", "fc1", "fc2")
    pairs = {k: _mk_lin(rng, 16, 16) for k in keys}
    jlayer = {k: j for k, (j, _) in pairs.items()}
    layer = torch.nn.Module()
    for k, (_, q) in pairs.items():
        setattr(layer, k, q)
    if case == "weight-only":
        jlayer["fc1"] = {k: v for k, v in jlayer["fc1"].items() if k != "act_q"}
        layer.fc1.act_q = False
    elif case == "dense":
        jlayer = {k: {"w": jnp.zeros((16, 16))} for k in keys}
        for k in keys:
            setattr(layer, k, Linear(16, 16))
    elif case == "int4":
        from videoitg_tpu_torch.ops.quant import quantize_linear_int4

        jlayer["q"] = dict(jax_quant.quantize_linear_int4({"w": jnp.zeros((16, 16))}),
                           act_q=None)
        layer.q = quantize_linear_int4(Linear(16, 16))
        layer.q.act_q = True
    want = jax_fused.can_fuse_encoder_layer(jlayer)
    assert fused.can_fuse_encoder_layer(layer) == want == (case == "act8")


# ---- the tower under act8, switch on and off ----


def _tower_pair():
    kw = dict(image_size=32, patch_size=16, hidden_size=64, intermediate_size=96,
              num_layers=3, num_heads=4)
    jcfg, cfg = JaxVisionConfig(**kw), VisionConfig(**kw)
    params = jax_init_siglip(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    qparams = jax_quant.enable_act_quant(jax_quant.quantize_siglip_int8(params),
                                         keys=jax_quant._SIGLIP_LINEAR_KEYS)
    tower = SiglipTower(cfg)
    tree = jax.tree.map(np.asarray, qparams)
    tower.pos_embed.data = torch.from_numpy(tree["pos_embed"].copy())
    tower.patch_embed.w.data = torch.from_numpy(tree["patch_embed"]["w"].copy())
    tower.patch_embed.b.data = torch.from_numpy(tree["patch_embed"]["b"].copy())
    for i, layer in enumerate(tower.layers):
        for key in ("ln1", "ln2"):
            getattr(layer, key).scale.data = torch.from_numpy(tree["layers"][key]["scale"][i].copy())
            getattr(layer, key).bias.data = torch.from_numpy(tree["layers"][key]["bias"][i].copy())
        for key in jax_quant._SIGLIP_LINEAR_KEYS:
            leaf = tree["layers"][key]
            setattr(layer, key, QuantLinear(
                w_qt=torch.from_numpy(leaf["w_q"][i].T.copy()),
                scale=torch.from_numpy(leaf["scale"][i].copy()),
                b=torch.from_numpy(leaf["b"][i].copy()), act_q=True))
    frames = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    return jcfg, cfg, qparams, tower, frames


def test_quantized_tower_switch_off_matches_jax_einsum_path():
    jcfg, cfg, qparams, tower, frames = _tower_pair()
    want = np.asarray(jax_siglip_features(qparams, jnp.asarray(frames), jcfg, use_flash=False))
    got = siglip_features(tower, torch.from_numpy(frames), cfg, use_flash=False).numpy()
    assert got.shape == want.shape
    # Flips compound over the 2 layers that run; the JAX test's structural bound.
    assert np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6) < 0.05
    # With the switch on but the plain attention asked for, the gate stays shut.
    same = siglip_features(tower, torch.from_numpy(frames), cfg, use_flash=False,
                           act8=Act8Switches(fused=True)).numpy()
    np.testing.assert_array_equal(same, got)


def test_quantized_tower_fused_matches_jax_fused_path(monkeypatch):
    jcfg, cfg, qparams, tower, frames = _tower_pair()
    monkeypatch.setenv("VIDEOITG_FUSED", "1")
    want = np.asarray(jax_siglip_features(qparams, jnp.asarray(frames), jcfg, use_flash=True))
    monkeypatch.delenv("VIDEOITG_FUSED")
    got = siglip_features(tower, torch.from_numpy(frames), cfg, use_flash=True,
                          act8=Act8Switches(fused=True)).numpy()
    unfused = siglip_features(tower, torch.from_numpy(frames), cfg, use_flash=True).numpy()
    scale = np.max(np.abs(want)) + 1e-6
    assert np.max(np.abs(got - want)) / scale < 0.05
    # the fused path quantises from fp32 LN values and so does the unfused one
    # in fp32: they track each other, and the switch does change the route.
    assert np.max(np.abs(got - unfused)) / scale < 0.05
    assert fused.fused_ln_qkv_int8.launches == 0  # CPU: plain versions, no launch
