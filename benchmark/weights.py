"""Weights made from the seed, on the device, in a few large draws.

One draw per kind of leaf and group of layers: every copy of a leaf in a
group comes out of one [layers of the group, ...] tensor drawn with a
`torch.Generator` on the device, in the dtype the model is served in, and
each layer's leaf is a view of it. The names and layouts are the port's
state dict (dense linears `w` [in, out]); the reference reads the same
dict. The same seed gives the same bits, so the check draws them again
after the port's state is freed.

The LM's leaves are its architecture's: a configuration's architecture
module (benchmark/reference/<name>.py) may give `lm_layer_groups(lm)` (the
groups of layers that have the same leaves, each with its specs) and
`lm_top_specs(lm)` (the LM's leaves outside its layers), with laws of its
own. Where it gives none, the Qwen2 LM's below are drawn: one group of every
layer, in the order the draws have always had, so that a configuration's
weights stay bit for bit what they were.

Qwen2's laws, one for every configuration of the model: linears N(0, 1/in), biases
and LayerNorm shifts N(0, 0.02^2), norm scales N(1, 0.02^2), embeddings
N(0, 0.02^2), the scoring head N(0, 2/(in+1)); but the LM's query and key
biases N(0, QK_BIAS^2). A query bias that large gives every head a strong
preference among the keys (b_q . W_k y_j), as trained heads have. With
small biases every image token spreads its attention evenly over ~13k keys,
so the ~100 instruction tokens move a frame's score by less than bfloat16
rounding does, and a check could not tell a stale or a wrong instruction's
answer from a right one; with these the instruction moves the scores by
many times the rounding.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

# (name under the layer, shape from the sizes, law, law's parameter)
Spec = Tuple[str, Tuple[int, ...], str, float]

QK_BIAS = 4.0


def vision_layer_specs(v: dict) -> List[Spec]:
    h, m = v["hidden_size"], v["intermediate_size"]
    specs: List[Spec] = []
    for ln in ("ln1", "ln2"):
        specs += [(f"{ln}.scale", (h,), "scale", 0.02), (f"{ln}.bias", (h,), "normal", 0.02)]
    for name, d_in, d_out in (("q", h, h), ("k", h, h), ("v", h, h), ("o", h, h),
                              ("fc1", h, m), ("fc2", m, h)):
        specs += [(f"{name}.w", (d_in, d_out), "normal", d_in ** -0.5),
                  (f"{name}.b", (d_out,), "normal", 0.02)]
    return specs


def lm_layer_specs(lm: dict) -> List[Spec]:
    h, m = lm["hidden_size"], lm["intermediate_size"]
    q_dim = lm["num_heads"] * lm["head_dim"]
    kv_dim = lm["num_kv_heads"] * lm["head_dim"]
    specs: List[Spec] = [("input_norm.scale", (h,), "scale", 0.02),
                         ("post_attn_norm.scale", (h,), "scale", 0.02)]
    for name, d_in, d_out, bias in (("q", h, q_dim, QK_BIAS), ("k", h, kv_dim, QK_BIAS),
                                    ("v", h, kv_dim, 0.02), ("o", q_dim, h, None),
                                    ("gate", h, m, None), ("up", h, m, None),
                                    ("down", m, h, None)):
        specs.append((f"{name}.w", (d_in, d_out), "normal", d_in ** -0.5))
        if bias is not None and lm["qkv_bias"]:
            specs.append((f"{name}.b", (d_out,), "normal", bias))
    return specs


def lm_layer_groups(lm: dict) -> List[Tuple[Sequence[int], List[Spec]]]:
    return [(range(lm["num_layers"]), lm_layer_specs(lm))]


def lm_top_specs(lm: dict) -> List[Spec]:
    return [("lm.embed.w", (lm["vocab_size"], lm["hidden_size"]), "normal", 0.02),
            ("lm.final_norm.scale", (lm["hidden_size"],), "scale", 0.02)]


def top_specs(model: dict, lm_top=lm_top_specs) -> List[Spec]:
    v, p, lm = model["vision"], model["projector"], model["lm"]
    grid = v["image_size"] // v["patch_size"]
    patch_dim = v["patch_size"] * v["patch_size"] * 3
    return [
        ("vision.pos_embed", (grid * grid, v["hidden_size"]), "normal", 0.02),
        ("vision.patch_embed.w", (patch_dim, v["hidden_size"]), "normal", patch_dim ** -0.5),
        ("vision.patch_embed.b", (v["hidden_size"],), "normal", 0.02),
        ("projector.fc1.w", (p["input_dim"], p["output_dim"]), "normal", p["input_dim"] ** -0.5),
        ("projector.fc1.b", (p["output_dim"],), "normal", 0.02),
        ("projector.fc2.w", (p["output_dim"], p["output_dim"]), "normal",
         p["output_dim"] ** -0.5),
        ("projector.fc2.b", (p["output_dim"],), "normal", 0.02),
    ] + lm_top(lm) + [
        ("out_proj.w", (lm["hidden_size"], 1), "normal", (2.0 / (lm["hidden_size"] + 1)) ** 0.5),
        ("out_proj.b", (1,), "normal", 0.02),
    ]


def _draw(shape, law: str, param: float, gen: torch.Generator, device, dtype) -> torch.Tensor:
    x = torch.empty(shape, device=device, dtype=dtype)
    if law == "scale":
        return x.normal_(1.0, param, generator=gen)
    return x.normal_(0.0, param, generator=gen)


def make_weights(model: dict, seed: int, device, dtype: torch.dtype,
                 arch=None) -> Dict[str, torch.Tensor]:
    """The state dict of the model described by `model` (a configuration
    file's "model" group), drawn from `seed` on `device` in `dtype`; the
    LM's leaves by the hooks of `arch`, the configuration's architecture
    module, where it has them."""
    lm = model["lm"]
    groups = [("vision", range(model["vision"]["num_layers"]),
               vision_layer_specs(model["vision"]))]
    groups += [("lm", layers, specs)
               for layers, specs in getattr(arch, "lm_layer_groups", lm_layer_groups)(lm)]
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, shape, law, param in top_specs(model, getattr(arch, "lm_top_specs", lm_top_specs)):
        out[name] = _draw(shape, law, param, gen, device, dtype)
    for tower, layers, specs in groups:
        layers = list(layers)
        for name, shape, law, param in specs:
            stack = _draw((len(layers),) + shape, law, param, gen, device, dtype)
            for j, i in enumerate(layers):
                out[f"{tower}.layers.{i}.{name}"] = stack[j]
    return out
