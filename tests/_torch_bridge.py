"""Helpers shared by tests/test_torch_train*.py, tests/test_torch_lora.py,
tests/test_torch_vlm*.py, tests/test_torch_checkpoint.py and tests/test_torch_clip.py:
models on bridged weights, batches from numpy seeds in both packages' forms,
and JAX trees (parameters, gradients) flattened to the port's parameter names."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from videoitg_tpu.config import preset as jax_preset
from videoitg_tpu.models.grounding import GroundingBatch as JaxBatch
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.config import preset as port_preset
from videoitg_tpu_torch.models.grounding import GroundingBatch


def to_numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def causal_cfgs(tie=True):
    """(jax cfg, port cfg) of the causal VLM at test size: tiny, `causal=True`,
    embeddings tied or not."""
    from videoitg_tpu import config as jax_config
    from videoitg_tpu_torch import config as port_config

    out = []
    for mod in (jax_config, port_config):
        base = mod.GroundingConfig.tiny()
        out.append(mod.GroundingConfig(
            vision=base.vision, projector=base.projector,
            lm=mod.LMConfig(**{**base.lm.__dict__, "causal": True, "tie_word_embeddings": tie}),
            max_text_len=base.max_text_len))
    return out


def family_cfgs(ptype="seq_mlp"):
    """(jax cfg, port cfg): tiny with the projector family `ptype`; identity
    keeps the tower's width, so the LM runs at it."""
    import dataclasses

    from videoitg_tpu import config as jax_config
    from videoitg_tpu_torch import config as port_config

    out = []
    for mod in (jax_config, port_config):
        cfg = mod.GroundingConfig.tiny()
        cfg = dataclasses.replace(cfg, projector=dataclasses.replace(
            cfg.projector, projector_type=ptype))
        if ptype == "identity":
            cfg = dataclasses.replace(cfg, lm=dataclasses.replace(
                cfg.lm, hidden_size=cfg.vision.hidden_size, head_dim=8, num_heads=4,
                num_kv_heads=2, intermediate_size=64))
        out.append(cfg)
    return out


def bridged_pair(params, name="tiny"):
    """(jax params, port model on the same numbers)."""
    return params, params_from_numpy(to_numpy_tree(params), port_preset(name))


def tiny_params(seed=7, name="tiny"):
    return jax_init_grounding(jax.random.PRNGKey(seed), jax_preset(name), dtype=jnp.float32)


def by_port_name(tree) -> dict:
    """A JAX tree (numpy-able leaves, stacked layers) -> {port parameter
    name: array}, e.g. tree['lm']['layers']['q']['w'][3] -> 'lm.layers.3.q.w'.
    `w_q` is left under its own name (the port stores it transposed as a
    buffer, not a parameter)."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(value, path + ".")
            elif value is not None:
                arr = np.asarray(value)
                head, sep, rest = path.partition(".layers.")
                if sep:
                    for i in range(arr.shape[0]):
                        out[f"{head}.layers.{i}.{rest}"] = arr[i]
                else:
                    out[path] = arr
    walk(tree, "")
    return out


def make_batches(cfg, seed, form, b=2, t_bucket=4, t_reals=(4, 3), l_txt=(9, 5)):
    """The same batch for both packages: (JaxBatch, GroundingBatch). `form`
    is 'frames' ([B, T, H, W, 3] pixels) or 'features' ([B, T, P, C])."""
    rng = np.random.default_rng(seed)
    if form == "frames":
        shape = (cfg.vision.image_size, cfg.vision.image_size, 3)
    else:
        shape = (cfg.vision.num_patches, cfg.vision.hidden_size)
    frames = np.zeros((b, t_bucket) + shape, np.float32)
    fv = np.zeros((b, t_bucket), bool)
    ids = np.zeros((b, cfg.max_text_len), np.int32)
    tv = np.zeros((b, cfg.max_text_len), bool)
    labels = np.zeros((b, t_bucket), np.float32)
    for i, (t, n) in enumerate(zip(t_reals, l_txt)):
        frames[i, :t] = rng.standard_normal((t,) + shape)
        fv[i, :t] = True
        ids[i, :n] = rng.integers(0, cfg.lm.vocab_size, n)
        tv[i, :n] = True
        labels[i, :t] = rng.random(t) < 0.4
    labels[0, 0] = 1.0
    arrays = (frames, fv, ids, tv, labels)
    jb = JaxBatch(*(jnp.asarray(a) for a in arrays))
    tb = GroundingBatch(*(torch.from_numpy(a) for a in arrays))
    return jb, GroundingBatch(tb.frames, tb.frame_valid, tb.text_ids.long(), tb.text_valid,
                              tb.labels)
