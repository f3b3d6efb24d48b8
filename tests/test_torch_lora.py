"""LoRA in the port against the JAX package: adapter shapes and scales on
the three bases, the adapted forward, `merge_lora`, and the weight bridge
with LoRA leaves, bit for bit. preset("tiny"), fp32, CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bridge import bridged_pair, make_batches, tiny_params, to_numpy_tree
from videoitg_tpu.config import preset
from videoitg_tpu.models.grounding import grounding_logits as jax_grounding_logits
from videoitg_tpu.ops.quant import quantize_grounding_int8, quantize_qwen2_int4
from videoitg_tpu.train import lora as jax_lora
from videoitg_tpu_torch.checkpoint import params_from_numpy, params_to_numpy
from videoitg_tpu_torch.config import preset as port_preset
from videoitg_tpu_torch.models import common
from videoitg_tpu_torch.models.grounding import grounding_logits
from videoitg_tpu_torch.ops import quant
from videoitg_tpu_torch.train import lora

BASES = {
    "dense": lambda p: p,
    "int8": quantize_grounding_int8,
    "int4": lambda p: dict(p, lm=quantize_qwen2_int4(p["lm"])),
}


def _random_b(tree, seed):
    """A JAX LoRA tree with B made non-zero, so that the adapters matter."""
    rng = np.random.default_rng(seed)
    layers = dict(tree["lm"]["layers"])
    for name in jax_lora.DEFAULT_TARGETS:
        lin = dict(layers[name])
        lin["lora_b"] = jnp.asarray(
            rng.standard_normal(lin["lora_b"].shape).astype(np.float32) * 0.05)
        layers[name] = lin
    return dict(tree, lm=dict(tree["lm"], layers=layers))


@pytest.mark.parametrize("base", sorted(BASES))
def test_add_lora_shapes_scale_and_start(base):
    cfg = preset("tiny")
    params = BASES[base](tiny_params(seed=1))
    want = jax_lora.add_lora(params, jax.random.PRNGKey(0), rank=4, alpha=12.0)
    _, model = bridged_pair(params)
    x = torch.randn(3, cfg.lm.hidden_size, generator=torch.Generator().manual_seed(0))
    before = common.linear(model.lm.layers[0].q, x)
    lora.add_lora(model, torch.Generator().manual_seed(0), rank=4, alpha=12.0)
    for i, layer in enumerate(model.lm.layers):
        for name in lora.DEFAULT_TARGETS:
            lin, ref = getattr(layer, name), want["lm"]["layers"][name]
            assert tuple(lin.lora_a.shape) == ref["lora_a"].shape[1:]
            assert tuple(lin.lora_b.shape) == ref["lora_b"].shape[1:]
            assert lin.lora_a.dtype == lin.lora_b.dtype == lin.lora_scale.dtype == torch.float32
            assert float(lin.lora_scale) == float(ref["lora_scale"][i]) == 3.0
            assert not lin.lora_b.any()
            # A ~ N(0, 1 / d_in): the same law as the JAX draw, not its bits.
            d_in = lin.lora_a.shape[0]
            assert abs(float(lin.lora_a.std()) * d_in ** 0.5 - 1.0) < 0.25
            assert not lin.lora_a.requires_grad
    assert not common.has_lora(model.out_proj) and not common.has_lora(model.vision.layers[0].q)
    # B = 0: the adapted model starts as the base.
    assert torch.equal(common.linear(model.lm.layers[0].q, x), before)


def test_add_lora_subset_of_targets_and_dtype():
    _, model = bridged_pair(tiny_params(seed=1))
    lora.add_lora(model, torch.Generator().manual_seed(1), rank=2, targets=("q", "v"),
                  dtype=torch.bfloat16)
    layer = model.lm.layers[0]
    assert common.has_lora(layer.q) and common.has_lora(layer.v)
    assert not common.has_lora(layer.k) and not common.has_lora(layer.down)
    assert layer.q.lora_a.dtype == torch.bfloat16 and layer.q.lora_scale.dtype == torch.float32


@pytest.mark.parametrize("base", sorted(BASES))
def test_bridge_round_trip_and_logits_with_adapters(base):
    cfg = preset("tiny")
    tree = _random_b(jax_lora.add_lora(BASES[base](tiny_params(seed=2)),
                                       jax.random.PRNGKey(3), rank=4), seed=4)
    numpy_tree = to_numpy_tree(tree)
    model = params_from_numpy(numpy_tree, port_preset("tiny"))
    back = params_to_numpy(model)
    flat_a = jax.tree_util.tree_flatten_with_path(numpy_tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (key, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    if base != "dense":
        assert isinstance(model.lm.layers[0].q, quant.QuantLinear)
    jb, tb = make_batches(cfg, 5, "features")
    want = np.asarray(jax_grounding_logits(tree, jb, cfg, hw=2))
    got = grounding_logits(model, tb, cfg, hw=2).detach().numpy()
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    np.testing.assert_allclose(got[finite], want[finite], atol=2e-5, rtol=1e-4)


def test_bf16_base_with_fp32_adapters():
    """x is cast up to the adapters' dtype and the delta back to y's, the
    promotion the JAX package gets implicitly."""
    rng = np.random.default_rng(6)
    lin = common.Linear(16, 8, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    a = rng.standard_normal((16, 2)).astype(np.float32)
    b = rng.standard_normal((2, 8)).astype(np.float32)
    common.set_lora(lin, torch.from_numpy(a), torch.from_numpy(b), torch.tensor(0.5))
    x = rng.standard_normal((5, 16)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    from videoitg_tpu.models.common import linear as jax_linear

    want = jax_linear({"w": jnp.asarray(lin.w.float().numpy(), jnp.bfloat16),
                       "b": jnp.asarray(lin.b.float().numpy(), jnp.bfloat16),
                       "lora_a": jnp.asarray(a), "lora_b": jnp.asarray(b),
                       "lora_scale": jnp.float32(0.5)}, xj)
    got = common.linear(lin, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=0.07, rtol=0.02)


def test_merge_lora_matches_jax_and_keeps_the_logits():
    cfg = preset("tiny")
    tree = _random_b(jax_lora.add_lora(tiny_params(seed=7), jax.random.PRNGKey(8), rank=4),
                     seed=9)
    _, model = bridged_pair(tree)
    _, tb = make_batches(cfg, 10, "features")
    adapted = grounding_logits(model, tb, cfg, hw=2).detach()
    lora.merge_lora(model)
    assert not any(common.has_lora(m) for m in model.modules() if hasattr(m, "lora_a"))
    want = to_numpy_tree(jax_lora.merge_lora(tree))
    got = params_to_numpy(model)
    assert "lora_a" not in got["lm"]["layers"]["q"]
    for name in jax_lora.DEFAULT_TARGETS:
        np.testing.assert_allclose(got["lm"]["layers"][name]["w"],
                                   want["lm"]["layers"][name]["w"], atol=1e-6)
    merged = grounding_logits(model, tb, cfg, hw=2)
    finite = torch.isfinite(adapted)
    assert torch.allclose(merged[finite], adapted[finite], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("base", ["int8", "int4"])
def test_merge_lora_refuses_a_quantised_base(base):
    _, model = bridged_pair(BASES[base](tiny_params(seed=11)))
    lora.add_lora(model, torch.Generator().manual_seed(0), rank=2)
    with pytest.raises(ValueError, match="quantized base"):
        lora.merge_lora(model)


def test_fused_qkv_falls_back_with_an_adapter():
    _, model = bridged_pair(tiny_params(seed=12))
    layer = model.lm.layers[0]
    x = torch.randn(2, 3, layer.q.w.shape[0], generator=torch.Generator().manual_seed(1))
    fused = common.fused_qkv(layer.q, layer.k, layer.v, x)
    common.set_lora(layer.k, torch.randn(layer.k.w.shape[0], 2), torch.randn(2, layer.k.w.shape[1]),
                    torch.tensor(1.0))
    q, k, v = common.fused_qkv(layer.q, layer.k, layer.v, x)
    assert torch.allclose(q, fused[0], atol=1e-6) and torch.allclose(v, fused[2], atol=1e-6)
    assert torch.equal(k, common.linear(layer.k, x)) and not torch.allclose(k, fused[1])
