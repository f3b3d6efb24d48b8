"""The port's model stack against the JAX package on the same weights.

Weights come from the JAX package's `init_grounding` and cross through the
bridge (`params_from_numpy`); inputs are made with numpy from a seed. fp32 on
the CPU; the JAX side runs `use_flash=True` through its Pallas kernels in
interpret mode, the port through its kernels' plain versions. Tolerance atol
2e-5, rtol 1e-4 (tests/test_engine.py) unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.config import preset
from videoitg_tpu.models import common as jax_common
from videoitg_tpu.models import projector as jax_projector
from videoitg_tpu.models import qwen2 as jax_qwen2
from videoitg_tpu.models import siglip as jax_siglip
from videoitg_tpu.models.grounding import GroundingBatch as JaxBatch
from videoitg_tpu.models.grounding import grounding_logits as jax_grounding_logits
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.ops.preprocess import preprocess_frames as jax_preprocess_frames
from videoitg_tpu_torch.checkpoint import params_from_numpy, params_to_numpy
from videoitg_tpu_torch.config import preset as port_preset
from videoitg_tpu_torch.models import common, projector, qwen2, siglip
from videoitg_tpu_torch.models.grounding import GroundingBatch, grounding_logits, init_grounding
from videoitg_tpu_torch.ops.preprocess import preprocess_frames

TOL = dict(atol=2e-5, rtol=1e-4)
PRESETS = ["tiny", "dryrun-serve"]


@pytest.fixture(scope="module", params=PRESETS)
def bridged(request):
    cfg = preset(request.param)
    params = jax_init_grounding(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tree, params_from_numpy(tree, port_preset(request.param))


def _batch(rng, cfg, b, t_bucket, t_reals, l_txt):
    s = cfg.vision.image_size
    frames = np.zeros((b, t_bucket, s, s, 3), np.float32)
    fv = np.zeros((b, t_bucket), bool)
    ids = np.zeros((b, cfg.max_text_len), np.int32)
    tv = np.zeros((b, cfg.max_text_len), bool)
    for i, (t, n) in enumerate(zip(t_reals, l_txt)):
        frames[i, :t] = rng.standard_normal((t, s, s, 3))
        fv[i, :t] = True
        ids[i, :n] = rng.integers(0, cfg.lm.vocab_size, n)
        tv[i, :n] = True
    return frames, fv, ids, tv


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_common_ops_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    norm = common.Norm(24, bias=True)
    norm.scale.data = torch.from_numpy(scale)
    norm.bias.data = torch.from_numpy(bias)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        common.rms_norm(norm, xt, 1e-6).numpy(),
        np.asarray(jax_common.rms_norm({"scale": scale}, x, 1e-6)), **TOL)
    np.testing.assert_allclose(
        common.layer_norm(norm, xt, 1e-6).numpy(),
        np.asarray(jax_common.layer_norm({"scale": scale, "bias": bias}, x, 1e-6)), **TOL)
    np.testing.assert_allclose(common.gelu_tanh(xt).numpy(),
                               np.asarray(jax_common.gelu_tanh(x)), **TOL)
    np.testing.assert_allclose(common.gelu_exact(xt).numpy(),
                               np.asarray(jax_common.gelu_exact(x)), **TOL)
    heads = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    pos = rng.integers(0, 20000, (2, 5))
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(heads), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jax_common.apply_rope(heads, pos.astype(np.int32), 1e6)), **TOL)


def test_linear_unported_forms_raise():
    """The LoRA linear form is refused by the bridge, where such trees
    arrive (the quantised forms cross, tests/test_torch_quant.py); a dense
    Linear computes x @ w + b."""
    cfg = preset("tiny")
    tree = jax.tree.map(np.asarray, jax_init_grounding(jax.random.PRNGKey(0), cfg))
    tree["out_proj"]["lora_a"] = np.zeros((cfg.lm.hidden_size, 1), np.float32)
    with pytest.raises(NotImplementedError, match="out_proj.lora_a: .* not ported"):
        params_from_numpy(tree, port_preset("tiny"))
    lin = common.Linear(4, 3)
    lin.w.data = torch.ones(4, 3)
    lin.b.data = torch.arange(3.0)
    assert common.linear(lin, torch.ones(2, 4)).tolist() == [[4.0, 5.0, 6.0]] * 2


@pytest.mark.parametrize("use_flash", [False, True])
def test_siglip_features_match_jax(bridged, use_flash):
    cfg, params, _, model = bridged
    rng = np.random.default_rng(1)
    s = cfg.vision.image_size
    images = rng.standard_normal((3, s, s, 3)).astype(np.float32)
    want = jax_siglip.siglip_features(params["vision"], jnp.asarray(images), cfg.vision,
                                      use_flash=use_flash)
    got = siglip.siglip_features(model.vision, torch.from_numpy(images), cfg.vision,
                                 use_flash=use_flash)
    assert got.shape == (3, cfg.vision.num_patches, cfg.vision.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [1, 2, 5, 12, 27])
def test_pool_frame_grid_and_projector_match_jax(hw):
    rng = np.random.default_rng(hw)
    cfg = preset("tiny").projector
    feats = rng.standard_normal((3, 729, cfg.input_dim)).astype(np.float32)
    np.testing.assert_allclose(
        projector.pool_frame_grid(torch.from_numpy(feats), hw).numpy(),
        np.asarray(jax_projector.pool_frame_grid(jnp.asarray(feats), hw)), **TOL)
    jp = jax_projector.init_projector(jax.random.PRNGKey(hw), cfg)
    proj = projector.Projector(cfg)
    for name in ("fc1", "fc2"):
        getattr(proj, name).w.data = torch.from_numpy(np.array(jp[name]["w"]))
        getattr(proj, name).b.data = torch.from_numpy(np.array(jp[name]["b"]))
    got = projector.apply_projector(proj, torch.from_numpy(feats), cfg, hw=hw)
    want = jax_projector.apply_projector(jp, jnp.asarray(feats), cfg, hw=hw)
    assert got.shape == (3, min(hw, 27) ** 2, cfg.output_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert projector.inference_hw(cfg, 100) == jax_projector.inference_hw(cfg, 100)


@pytest.mark.parametrize("use_flash", [False, True])
def test_qwen2_hidden_states_match_jax(bridged, use_flash):
    """Packed positions (image slots, then text after the valid image
    prefix) and a validity mask, as the grounding layout feeds them."""
    cfg, params, _, model = bridged
    rng = np.random.default_rng(2)
    b, n_img, n_txt = 2, 12, 9
    s = n_img + n_txt
    x = rng.standard_normal((b, s, cfg.lm.hidden_size)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[0, 8:n_img] = False  # bucket-padding frames
    valid[:, n_img + 5:] = False  # text padding
    n_valid_img = valid[:, :n_img].sum(1, keepdims=True)
    pos = np.concatenate([np.broadcast_to(np.arange(n_img), (b, n_img)),
                          n_valid_img + np.arange(n_txt)], axis=1).astype(np.int32)
    want = jax_qwen2.qwen2_hidden_states(params["lm"], jnp.asarray(x), jnp.asarray(pos),
                                         jnp.asarray(valid), cfg.lm, use_flash=use_flash)
    got = qwen2.qwen2_hidden_states(model.lm, torch.from_numpy(x), torch.from_numpy(pos),
                                    torch.from_numpy(valid), cfg.lm, use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ids = rng.integers(0, cfg.lm.vocab_size, (2, 5))
    np.testing.assert_array_equal(qwen2.embed_tokens(model.lm, torch.from_numpy(ids)).numpy(),
                                  np.asarray(jax_qwen2.embed_tokens(params["lm"], ids)))


@pytest.mark.parametrize("use_flash", [False, True])
def test_grounding_logits_match_jax(bridged, use_flash):
    cfg, params, _, model = bridged
    rng = np.random.default_rng(3)
    frames, fv, ids, tv = _batch(rng, cfg, 2, 8, [8, 5], [7, 3])
    hw = 1
    want = jax_grounding_logits(params, JaxBatch(jnp.asarray(frames), jnp.asarray(fv),
                                                 jnp.asarray(ids), jnp.asarray(tv)),
                                cfg, hw=hw, use_flash=use_flash, vision_chunk=4)
    got = grounding_logits(model, GroundingBatch(*_torch(frames, fv, ids, tv)), cfg, hw=hw,
                           use_flash=use_flash, vision_chunk=4)
    want = np.asarray(want)
    assert np.isneginf(got.numpy()[~fv]).all() and np.isneginf(want[~fv]).all()
    np.testing.assert_allclose(got.numpy()[fv], want[fv], **TOL)


def test_grounding_logits_feature_form_and_hw2(bridged):
    """The 4-d features form skips the tower; hw 2 pools the grid."""
    cfg, params, _, model = bridged
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((1, 4, cfg.vision.num_patches, cfg.vision.hidden_size))
    feats = feats.astype(np.float32)
    _, fv, ids, tv = _batch(rng, cfg, 1, 4, [3], [6])
    want = jax_grounding_logits(params, JaxBatch(jnp.asarray(feats), jnp.asarray(fv),
                                                 jnp.asarray(ids), jnp.asarray(tv)), cfg, hw=2)
    got = grounding_logits(model, GroundingBatch(*_torch(feats, fv, ids, tv)), cfg, hw=2)
    np.testing.assert_allclose(got.numpy()[fv], np.asarray(want)[fv], **TOL)


def test_params_round_trip_is_bit_exact(bridged):
    cfg, _, tree, model = bridged
    back = params_to_numpy(model)
    flat_in = dict(_leaves(tree))
    flat_out = dict(_leaves(back))
    assert flat_in.keys() == flat_out.keys()
    for key, arr in flat_in.items():
        assert flat_out[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(flat_out[key], arr, err_msg=key)
    again = params_from_numpy(back, cfg)
    for (k1, v1), (k2, v2) in zip(model.state_dict().items(), again.state_dict().items()):
        assert k1 == k2 and torch.equal(v1, v2)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def test_bridge_rejects_quantised_trees():
    """... that are malformed: an int8 weight without its scale, or with a
    key the port does not know. A well-formed quantised tree crosses."""
    from videoitg_tpu.ops.quant import quantize_grounding_int8
    from videoitg_tpu_torch.ops.quant import QuantLinear

    cfg = port_preset("tiny")
    params = quantize_grounding_int8(jax_init_grounding(jax.random.PRNGKey(0), preset("tiny")))
    tree = jax.tree.map(np.asarray, params)
    assert isinstance(params_from_numpy(tree, cfg).lm.layers[0].q, QuantLinear)
    broken = dict(tree, lm=dict(tree["lm"], layers=dict(tree["lm"]["layers"])))
    broken["lm"]["layers"]["q"] = {k: v for k, v in tree["lm"]["layers"]["q"].items()
                                   if k != "scale"}
    with pytest.raises(KeyError, match="quantised linear"):
        params_from_numpy(broken, cfg)
    broken["lm"]["layers"]["q"] = dict(tree["lm"]["layers"]["q"], zero_point=np.zeros(3))
    with pytest.raises(KeyError, match="quantised linear"):
        params_from_numpy(broken, cfg)


def test_torch_init_follows_the_jax_distributions():
    """Random init draws from a torch.Generator with the JAX package's laws:
    N(0, 1/in) linears, zero biases, unit norms, N(0, 0.02^2) embeddings,
    Xavier-uniform head."""
    cfg = preset("dryrun-serve")
    model = init_grounding(cfg, torch.Generator().manual_seed(0))
    again = init_grounding(cfg, torch.Generator().manual_seed(0))
    for (_, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b)
    w = model.lm.layers[0].gate.w
    assert abs(w.std().item() * cfg.lm.hidden_size ** 0.5 - 1.0) < 0.05
    assert torch.count_nonzero(model.lm.layers[0].q.b) == 0
    assert torch.all(model.vision.layers[0].ln1.scale == 1)
    assert abs(model.lm.embed.w.std().item() - 0.02) < 0.002
    bound = (6.0 / (cfg.lm.hidden_size + 1)) ** 0.5
    assert model.out_proj.w.abs().max().item() <= bound


def test_preprocess_frames_matches_jax():
    """PIL-faithful resize with inter-pass round/clip: the integral resize
    agrees exactly, so only the fp32 normalise can differ (atol 1e-6)."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, 37, 61, 3), dtype=np.uint8)
    want = np.asarray(jax_preprocess_frames(jnp.asarray(frames), out_size=56))
    got = preprocess_frames(torch.from_numpy(frames), out_size=56).numpy()
    assert got.shape == (2, 56, 56, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
