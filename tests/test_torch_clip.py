"""The clip vision arch and the projector families of the port against the
JAX package and HF torch oracles (tests/test_model_parity.py's cases).

No preset uses either, so they reach the models through a checkpoint: a tiny
HF `CLIPVisionModel` (quick_gelu, eps 1e-5) is spliced under
`model.vision_tower.vision_tower.` into a JAX-exported tiny state dict, and
both packages' converters read it; the projector families come from the
JAX package's `init_grounding` through the bridge and from torch modules
spliced under `model.mm_projector.`. fp32 on the CPU; atol 2e-5, rtol 1e-4
unless a test says otherwise. The fused act8 clip layer (its kernels' plain
versions here) is held to the JAX `_encoder_layer_fused` in interpret mode at
tests/test_torch_fused_encoder.py's `_tol`.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bridge import family_cfgs
from videoitg_tpu import checkpoint as jax_ckpt
from videoitg_tpu.config import GroundingConfig as JaxConfig
from videoitg_tpu.config import VisionConfig as JaxVisionConfig
from videoitg_tpu.models import siglip as jax_siglip
from videoitg_tpu.models.grounding import GroundingBatch as JaxBatch
from videoitg_tpu.models.grounding import grounding_logits as jax_grounding_logits
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.models.projector import apply_projector as jax_apply_projector
from videoitg_tpu.ops import quant as jax_quant
from videoitg_tpu_torch import checkpoint as ckpt
from videoitg_tpu_torch.config import GroundingConfig, VisionConfig
from videoitg_tpu_torch.models import siglip
from videoitg_tpu_torch.models.common import Norm
from videoitg_tpu_torch.models.grounding import GroundingBatch, grounding_logits, init_grounding
from videoitg_tpu_torch.models.projector import Projector, apply_projector
from videoitg_tpu_torch.ops.quant import QuantLinear

TOL = dict(atol=2e-5, rtol=1e-4)
VISION = "model.vision_tower.vision_tower."
CLIP = dict(hidden_size=32, intermediate_size=64, num_layers=3, num_heads=4, image_size=56,
            patch_size=14, layer_norm_eps=1e-5, select_layer=-2, arch="clip")


def _cfgs(select_feature="patch", **projector):
    """(JAX config, port config): tiny with the clip tower."""
    out = []
    for mod, vmod in ((JaxConfig, JaxVisionConfig), (GroundingConfig, VisionConfig)):
        base = mod.tiny()
        out.append(dataclasses.replace(
            base, vision=vmod(**CLIP, select_feature=select_feature),
            projector=dataclasses.replace(base.projector, **projector)))
    return out


def _hf_clip():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    hf_cfg = CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
        image_size=56, patch_size=14, layer_norm_eps=1e-5, hidden_act="quick_gelu",
        attn_implementation="eager")
    torch.manual_seed(11)
    model = CLIPVisionModel(hf_cfg).eval()
    with torch.no_grad():  # LN weights away from their init of ones and zeros
        for name, p in model.named_parameters():
            if "layer_norm" in name or "layrnorm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return model


@functools.lru_cache(maxsize=None)
def _spliced_checkpoint(ptype="seq_mlp"):
    """(numpy HF state dict, HF CLIP model): a JAX-exported tiny grounding
    checkpoint with its tower replaced by the CLIP model's. Built once and
    shared: the tests only read both."""
    base = JaxConfig.tiny()
    jcfg = dataclasses.replace(base, projector=dataclasses.replace(base.projector,
                                                                    projector_type=ptype))
    params = jax_init_grounding(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    sd = {k: np.ascontiguousarray(v)
          for k, v in jax_ckpt.export_grounding_state_dict(params, jcfg).items()
          if not k.startswith(VISION)}
    hf = _hf_clip()
    for k, v in hf.state_dict().items():
        if "post_layernorm" not in k and "position_ids" not in k:
            sd[VISION + k] = v.numpy().copy()
    return sd, hf


def _both(sd, jcfg, cfg):
    """The same checkpoint through both packages' converters."""
    params = jax_ckpt.convert_grounding_checkpoint(sd, jcfg, dtype=jnp.float32)
    model = ckpt.convert_grounding_checkpoint({k: torch.from_numpy(v.copy())
                                               for k, v in sd.items()}, cfg, device="cpu")
    return params, model


@pytest.mark.parametrize("select_feature", ["patch", "cls_patch"])
def test_clip_tower_features_match_hf_and_jax(select_feature):
    jcfg, cfg = _cfgs(select_feature)
    sd, hf = _spliced_checkpoint()
    params, model = _both(sd, jcfg, cfg)
    assert tuple(model.vision.pos_embed.shape) == (17, 32) and model.vision.patch_embed.b is None
    images = np.random.default_rng(11).standard_normal((2, 56, 56, 3)).astype(np.float32)
    got = siglip.siglip_features(model.vision, torch.from_numpy(images), cfg.vision).numpy()
    want = np.asarray(jax_siglip.siglip_features(params["vision"], jnp.asarray(images),
                                                 jcfg.vision))
    with torch.no_grad():
        hidden = hf(torch.from_numpy(images.transpose(0, 3, 1, 2)),
                    output_hidden_states=True).hidden_states[-2].numpy()
    oracle = hidden[:, 1:] if select_feature == "patch" else hidden
    assert got.shape == want.shape == oracle.shape == (2, 16 + (select_feature != "patch"), 32)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_clip_grounding_logits_match_jax():
    """The whole grounding model on the clip tower, a padding frame masked."""
    jcfg, cfg = _cfgs()
    sd, _ = _spliced_checkpoint()
    params, model = _both(sd, jcfg, cfg)
    rng = np.random.default_rng(12)
    frames = rng.standard_normal((1, 3, 56, 56, 3)).astype(np.float32)
    fv = np.array([[True, True, False]])
    ids = rng.integers(0, cfg.lm.vocab_size, (1, 6)).astype(np.int32)
    tv = np.array([[True] * 5 + [False]])
    want = np.asarray(jax_grounding_logits(params, JaxBatch(
        jnp.asarray(frames), jnp.asarray(fv), jnp.asarray(ids), jnp.asarray(tv)), jcfg, hw=2))
    got = grounding_logits(model, GroundingBatch(*(torch.from_numpy(a) for a in
                                                    (frames, fv, ids, tv))), cfg, hw=2).numpy()
    assert got[0, 2] == want[0, 2] == -np.inf
    np.testing.assert_allclose(got[:, :2], want[:, :2], **TOL)


def test_clip_checkpoint_round_trip_and_random_init():
    """The port writes the clip keys (`class_embedding`, `pre_layrnorm`, no
    conv bias) back as it read them; a random-init clip tower has them too."""
    jcfg, cfg = _cfgs()
    sd, _ = _spliced_checkpoint()
    _, model = _both(sd, jcfg, cfg)
    back = ckpt.export_grounding_state_dict(model, cfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    tower = init_grounding(cfg, torch.Generator().manual_seed(0)).vision
    assert tower.cls_embed.shape == (32,) and tower.pos_embed.shape == (17, 32)
    assert torch.equal(tower.pre_ln.scale, torch.ones(32)) and tower.patch_embed.b is None
    assert float(tower.cls_embed.std()) > 0
    tree = ckpt.params_to_numpy(model)
    assert set(tree["vision"]) >= {"cls_embed", "pre_ln"}
    again = ckpt.params_from_numpy(tree, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


# ---- the projector families ----


@pytest.mark.parametrize("ptype", ["linear", "mlp3x_gelu", "identity"])
def test_projector_families_match_jax_through_grounding_logits(ptype):
    jcfg, cfg = family_cfgs(ptype)
    params = jax_init_grounding(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = ckpt.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    want_keys = {"linear": {"fc1"}, "mlp3x_gelu": {"fc1", "fc2", "fc3"}, "identity": set()}
    assert {n.split(".")[0] for n, _ in model.projector.named_parameters()} == want_keys[ptype]
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((1, 3, 56, 56, 3)).astype(np.float32)
    fv = np.array([[True, True, False]])
    ids = rng.integers(0, cfg.lm.vocab_size, (1, 4)).astype(np.int32)
    tv = np.ones((1, 4), bool)
    want = np.asarray(jax_grounding_logits(params, JaxBatch(
        jnp.asarray(frames), jnp.asarray(fv), jnp.asarray(ids), jnp.asarray(tv)), jcfg, hw=2))
    got = grounding_logits(model, GroundingBatch(*(torch.from_numpy(a) for a in
                                                    (frames, fv, ids, tv))), cfg, hw=2).numpy()
    assert got.shape == (1, 3) and got[0, 2] == want[0, 2] == -np.inf
    assert np.all(np.isfinite(got[0, :2]))
    np.testing.assert_allclose(got[:, :2], want[:, :2], **TOL)


@pytest.mark.parametrize("ptype", ["linear", "mlp2x_gelu", "mlp3x_gelu"])
def test_projector_families_match_torch_modules(ptype):
    """The reference factory's modules (a bare Linear; Sequential(Linear,
    GELU, Linear, ...)) spliced under `model.mm_projector.` into a
    checkpoint: the port reads them and applies them as torch does."""
    from videoitg_tpu_torch.models.projector import _depth

    jcfg, cfg = family_cfgs(ptype)
    params = jax_init_grounding(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    sd = {k: torch.from_numpy(np.array(v, order="C"))
          for k, v in jax_ckpt.export_grounding_state_dict(params, jcfg).items()}
    torch.manual_seed(5)
    d_in, d_out = cfg.projector.input_dim, cfg.projector.output_dim
    if ptype == "linear":
        module = torch.nn.Linear(d_in, d_out)
    else:
        layers = [torch.nn.Linear(d_in, d_out)]
        for _ in range(1, _depth(ptype)):
            layers += [torch.nn.GELU(), torch.nn.Linear(d_out, d_out)]
        module = torch.nn.Sequential(*layers)
    sd.update({f"model.mm_projector.{k}": v.detach() for k, v in module.state_dict().items()})
    model = ckpt.convert_grounding_checkpoint(sd, cfg, device="cpu")
    feats = torch.from_numpy(np.random.default_rng(13).standard_normal((3, 9, d_in))
                             .astype(np.float32))
    with torch.no_grad():
        want = module(feats).numpy()
    got = apply_projector(model.projector, feats, cfg.projector).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jax_params = jax_ckpt.convert_grounding_checkpoint({k: v.numpy() for k, v in sd.items()},
                                                       jcfg)
    want_jax = np.asarray(jax_apply_projector(jax_params["projector"],
                                              jnp.asarray(feats.numpy()), jcfg.projector))
    np.testing.assert_allclose(got, want_jax, **TOL)


def test_identity_and_unknown_families():
    cfg = GroundingConfig.tiny().projector
    ident = Projector(dataclasses.replace(cfg, projector_type="identity"))
    assert not list(ident.parameters())
    feats = torch.randn(2, 4, 32)
    assert apply_projector(ident, feats, dataclasses.replace(cfg, projector_type="identity")) \
        is feats
    with pytest.raises(ValueError, match="unknown projector type 'mlpx_gelu'"):
        Projector(dataclasses.replace(cfg, projector_type="mlpx_gelu"))
    with pytest.raises(ValueError, match="seq_mlp needs the per-video hw"):
        apply_projector(Projector(cfg), feats, cfg)


# ---- the fused act8 clip layer ----


TIGHT = dict(rtol=2e-5, atol=2e-5)


def _tol(ref) -> float:
    return 4.0 * float(np.max(np.abs(ref))) / 127.0 + 1e-5


def test_fused_act8_clip_layer_matches_jax_interpret():
    """One clip encoder layer under act8 through the three fused kernels
    (H with quick_gelu): the port's plain versions against the JAX Pallas
    kernels in interpret mode."""
    kw = dict(CLIP, hidden_size=64, intermediate_size=128, num_heads=4)
    jcfg, cfg = JaxVisionConfig(**kw), VisionConfig(**kw)
    rng = np.random.default_rng(21)
    h, m = 64, 128
    jlayer, layer = {}, siglip.SiglipLayer(cfg)
    for key, (d_in, d_out) in {"q": (h, h), "k": (h, h), "v": (h, h), "o": (h, h),
                               "fc1": (h, m), "fc2": (m, h)}.items():
        lin = {"w": jnp.asarray(rng.standard_normal((d_in, d_out)) * d_in ** -0.5, jnp.float32),
               "b": jnp.asarray(rng.standard_normal(d_out) * 0.02, jnp.float32)}
        jq = dict(jax_quant.quantize_linear_int8(lin), act_q=None)
        jlayer[key] = jq
        setattr(layer, key, QuantLinear(w_qt=torch.from_numpy(np.asarray(jq["w_q"]).T.copy()),
                                        scale=torch.from_numpy(np.asarray(jq["scale"]).copy()),
                                        b=torch.from_numpy(np.asarray(jq["b"]).copy()),
                                        act_q=True))
    for key in ("ln1", "ln2"):
        scale = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
        bias = (0.1 * rng.standard_normal(h)).astype(np.float32)
        jlayer[key] = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        norm = Norm(h, bias=True)
        norm.scale.data, norm.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
        setattr(layer, key, norm)
    x = rng.standard_normal((2, 17, h)).astype(np.float32)
    want = np.asarray(jax_siglip._encoder_layer_fused(jlayer, jnp.asarray(x), jcfg))
    got = siglip._encoder_layer_fused(layer, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)
    # a rounding that flips moves few values: most agree tightly
    assert np.mean(~np.isclose(got, want, **TIGHT)) < 0.05
    # quick_gelu, not SigLIP's gelu_tanh: the same layer with the other
    # activation is further off.
    siglip_cfg = dataclasses.replace(cfg, arch="siglip")
    other = siglip._encoder_layer_fused(layer, torch.from_numpy(x), siglip_cfg).numpy()
    assert np.mean(~np.isclose(other, want, **TIGHT)) > 0.5
