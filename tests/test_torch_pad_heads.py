"""Lane-padded vision heads on the port (models/siglip.pad_attention_heads)
against the JAX package's, at GroundingConfig.tiny() (head_dim 8, lane 16),
fp32: the cases of tests/test_pad_heads.py (dense and int8 + act_q, the
padded features exactly equal to the unpadded ones through the plain path),
the port's padding leaf for leaf equal to the JAX padding bridged, and the
port's padded features against the JAX package's at atol 2e-5."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bridge import to_numpy_tree
from videoitg_tpu.config import GroundingConfig as JaxConfig
from videoitg_tpu.models import siglip as jax_siglip
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.ops.quant import _SIGLIP_LINEAR_KEYS
from videoitg_tpu.ops.quant import enable_act_quant as jax_enable_act_quant
from videoitg_tpu.ops.quant import quantize_siglip_int8 as jax_quantize_siglip_int8
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models import siglip
from videoitg_tpu_torch.ops.quant import Act8Switches, QuantLinear

LANE = 16
CFG = GroundingConfig.tiny()
FORMS = ["dense", "int8"]


@functools.lru_cache(maxsize=None)
def jax_params(form):
    init = jax.jit(functools.partial(jax_init_grounding, cfg=JaxConfig.tiny(), dtype=jnp.float32))
    params = dict(init(jax.random.PRNGKey(0)))
    if form == "int8":
        params["vision"] = jax_enable_act_quant(jax_quantize_siglip_int8(params["vision"]),
                                                keys=_SIGLIP_LINEAR_KEYS)
    return params


def jax_padded(params):
    return {**params, "vision": jax_siglip.pad_attention_heads(params["vision"],
                                                               JaxConfig.tiny().vision,
                                                               lane=LANE)}


def frames(n=2):
    s = CFG.vision.image_size
    return np.random.default_rng(1).standard_normal((n, s, s, 3)).astype(np.float32)


def tower(params):
    return params_from_numpy(to_numpy_tree(params), CFG).vision


@pytest.mark.parametrize("form", FORMS)
def test_padded_features_equal_unpadded(form):
    """Zero lanes add exact zeros: the plain path gives the same bits."""
    base = tower(jax_params(form))
    padded = siglip.pad_attention_heads(base, CFG.vision, lane=LANE)
    assert padded.layers[0].q is not base.layers[0].q  # a copy; the input is untouched
    assert tuple(base.layers[0].o.w_qt.shape if form == "int8" else base.layers[0].o.w.shape) \
        == (CFG.vision.hidden_size,) * 2
    x = torch.from_numpy(frames())
    want = siglip.siglip_features(base, x, CFG.vision, use_flash=False)
    got = siglip.siglip_features(padded, x, CFG.vision, use_flash=False)
    assert float((got - want).abs().max()) == 0.0
    if form == "int8":
        # the fused int8 layer refuses a padded q: the switch changes nothing
        fused = siglip.siglip_features(padded, x, CFG.vision, use_flash=True,
                                       act8=Act8Switches(fused=True))
        plain = siglip.siglip_features(padded, x, CFG.vision, use_flash=True)
        assert torch.equal(fused, plain)


@pytest.mark.parametrize("form", FORMS)
def test_padded_leaves_equal_the_jax_padding(form):
    params = jax_params(form)
    want = tower(jax_padded(params))
    got = siglip.pad_attention_heads(tower(params), CFG.vision, lane=LANE)
    want_sd, got_sd = want.state_dict(), got.state_dict()
    assert set(got_sd) == set(want_sd)
    for name, t in got_sd.items():
        assert t.dtype == want_sd[name].dtype and torch.equal(t, want_sd[name]), name
    h = CFG.vision.num_heads * LANE
    for layer, ref in zip(got.layers, want.layers):
        for key in ("q", "k", "v", "o"):
            lin = getattr(layer, key)
            assert isinstance(lin, QuantLinear) == (form == "int8")
            if form == "int8":
                assert lin.act_q and getattr(ref, key).act_q
                assert lin.w_qt.shape == ((h, CFG.vision.hidden_size) if key != "o"
                                          else (CFG.vision.hidden_size, h))


@pytest.mark.parametrize("use_flash", [False, True])
def test_padded_features_match_jax(use_flash):
    params = jax_params("dense")
    x = frames()
    want = jax_siglip.siglip_features(jax_padded(params)["vision"], jnp.asarray(x),
                                      JaxConfig.tiny().vision, use_flash=False)
    padded = siglip.pad_attention_heads(tower(params), CFG.vision, lane=LANE)
    got = siglip.siglip_features(padded, torch.from_numpy(x), CFG.vision, use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_refuses_what_it_cannot_pad():
    base = tower(jax_params("dense"))
    with pytest.raises(ValueError, match="wider than lane"):
        siglip.pad_attention_heads(base, CFG.vision, lane=CFG.vision.head_dim - 1)
