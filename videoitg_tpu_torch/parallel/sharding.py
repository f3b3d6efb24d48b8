"""Parameter partition specs of the grounding model, and the slicing of a
model's leaves onto one rank.

Counterpart of videoitg_tpu/parallel/sharding.py, with its Megatron layout:

  * attention: q/k/v output features sharded over tp (head-aligned: 28 q and
    4 kv heads divide tp in {1, 2, 4}), o_proj input sharded, so the
    all-reduce after o_proj is the attention's only collective;
  * MLP: gate/up (tower: fc1) output sharded, down (fc2) input sharded;
  * embeddings: vocab rows sharded (a masked local gather, then a sum);
  * norms, positions, the scoring head: replicated;
  * pp: the stacked-layer axis over the pipeline stages.

A spec is a tuple with one mesh axis name (or None) per dimension of the JAX
leaf, the JAX `PartitionSpec`; the spec trees mirror the JAX parameter
tree, decoder and tower layers stacked. `adapt_specs_to_params` maps them
onto the port's module tree, leaf by dotted name, in the port's layouts;
`shard_model` keeps on one rank only its slice of every leaf, as a pure
function of (model, specs, mesh coordinates), and marks each sharded linear
and the embedding with a `TPShard` that says which collective its product
needs (parallel/tensor.py).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn

from videoitg_tpu_torch.models.common import LORA_KEYS
from videoitg_tpu_torch.parallel.mesh import PP_AXIS, TP_AXIS

Spec = tuple


def qwen2_param_specs(pp: bool = False) -> dict:
    """Specs of the LM tree (stacked layers); pp=True also shards the layer
    axis over the stages."""
    t = TP_AXIS
    s0 = PP_AXIS if pp else None
    return {
        "embed": {"w": (t, None)},
        "layers": {
            "input_norm": {"scale": (s0, None)},
            "post_attn_norm": {"scale": (s0, None)},
            "q": {"w": (s0, None, t), "b": (s0, t)},
            "k": {"w": (s0, None, t), "b": (s0, t)},
            "v": {"w": (s0, None, t), "b": (s0, t)},
            "o": {"w": (s0, t, None)},
            "gate": {"w": (s0, None, t)},
            "up": {"w": (s0, None, t)},
            "down": {"w": (s0, t, None)},
        },
        "final_norm": {"scale": (None,)},
    }


def siglip_param_specs() -> dict:
    t = TP_AXIS
    layer = {
        "ln1": {"scale": (None, None), "bias": (None, None)},
        "ln2": {"scale": (None, None), "bias": (None, None)},
        "q": {"w": (None, None, t), "b": (None, t)},
        "k": {"w": (None, None, t), "b": (None, t)},
        "v": {"w": (None, None, t), "b": (None, t)},
        "o": {"w": (None, t, None), "b": (None, None)},
        "fc1": {"w": (None, None, t), "b": (None, t)},
        "fc2": {"w": (None, t, None), "b": (None, None)},
    }
    return {
        "patch_embed": {"w": (None, t), "b": (t,)},
        "pos_embed": (None, None),
        "layers": layer,
    }


def grounding_param_specs(with_lm_head: bool = False, pp: bool = False) -> dict:
    t = TP_AXIS
    specs = {
        "vision": siglip_param_specs(),
        "projector": {
            "fc1": {"w": (None, t), "b": (t,)},
            "fc2": {"w": (t, None), "b": (None,)},
        },
        "lm": qwen2_param_specs(pp=pp),
        "out_proj": {"w": (None, None), "b": (None,)},
    }
    if with_lm_head:
        specs["lm"]["lm_head"] = {"w": (None, t)}
    return specs


def _spec_node(specs: Mapping, path: list):
    """The spec subtree at a module path, the layer index of a stacked
    layer dropped; (node, stacked) or (None, False) where the tree has none."""
    node, stacked = specs, False
    for part in path:
        if part.isdigit() and stacked is False and isinstance(node, dict):
            stacked = True  # the index into a stacked "layers" axis
            continue
        if not isinstance(node, dict) or part not in node:
            return None, False
        node = node[part]
    return node, stacked


def _unstack(spec: Spec, stacked: bool) -> Spec:
    """A stacked leaf's spec without its layer axis (that axis is pp's)."""
    return spec[1:] if stacked else spec


def adapt_specs_to_params(specs: Any, model: nn.Module) -> Dict[str, Spec]:
    """{dotted leaf name: spec over the port tensor's own axes} for every
    parameter and buffer of `model`, dense or quantised:

    * an int8 `w_qt` ([out, in], the JAX `w_q` transposed) is sharded like
      `w`, axes reversed; packed int4 `w_q4` like `w` (`shard_model` keeps a
      row-parallel rank's own input rows, repacked); `scale` / `scale4`
      follow the out axis, so a
      column-parallel linear shards its scales with its columns and a
      row-parallel one replicates them;
    * LoRA leaves are replicated (tiny; parallel/tensor.py slices them at
      use);
    * a leaf the spec tree does not name (CLIP's class embedding and
      pre-layernorm, a deeper projector's fc3...) is replicated.

    A stacked leaf's layer axis is dropped: `shard_model` reads pp from the
    tree itself."""
    out = {}
    for name, tensor in list(model.named_parameters()) + list(model.named_buffers()):
        *mod_path, leaf = name.split(".")
        node, stacked = _spec_node(specs, mod_path)
        node = node if isinstance(node, dict) else {}
        spec = (None,) * tensor.dim()
        if leaf in LORA_KEYS:
            pass
        elif leaf in ("w_qt", "w_q4", "scale", "scale4", "b") and "w" in node:
            w_spec = _unstack(node["w"], stacked)
            out_spec = w_spec[:-2] + w_spec[-1:]
            if leaf == "b":
                spec = _unstack(node["b"], stacked) if "b" in node else out_spec
            else:
                spec = {"w_qt": w_spec[::-1], "w_q4": w_spec}.get(leaf, out_spec)
        elif leaf in node:
            spec = _unstack(node[leaf], stacked)
        if len(spec) != tensor.dim():
            raise ValueError(f"spec {spec} of {name} does not fit its shape "
                             f"{tuple(tensor.shape)}")
        out[name] = spec
    return out


class TPShard(NamedTuple):
    """How a sharded module computes: "col" (output features local), "col_gather"
    (output features local, gathered whole), "row" (input features local,
    partial products summed over tp) or "vocab" (embedding rows local).
    `rank` / `size` place the slice on the tp axis; `group` is the tp
    process group (None where no collective runs, as in the tests of the
    slices themselves)."""

    kind: str
    rank: int
    size: int
    group: Optional[object] = None


# Column-parallel linears whose consumer needs every output feature: the
# tower's patch embedding (the positions and the layers read it whole) and a
# one-linear projector's fc1 (the LM reads it whole).
def _gathered(model: nn.Module) -> set:
    names = {"vision.patch_embed"}
    proj = getattr(model, "projector", None)
    if proj is not None and hasattr(proj, "fc1") and not hasattr(proj, "fc2"):
        names.add("projector.fc1")
    return names


def _slice(tensor: torch.Tensor, spec: Spec, shape: Mapping[str, int],
           coords: Mapping[str, int]) -> torch.Tensor:
    out = tensor
    for dim, axis in enumerate(spec):
        n = shape.get(axis, 1) if axis is not None else 1
        if n == 1:
            continue
        size = tensor.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} ({size}) does not split over {axis}={n}")
        step = size // n
        out = out.narrow(dim, coords[axis] * step, step)
    return out


def _int4_rows(packed: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Input rows [rank in/tp, (rank+1) in/tp) of a packed-int4 weight,
    repacked. (The JAX shard of the packed array would hold rows
    [rank h, (rank+1) h) of each half of the input axis, h = in / 2tp, which
    are not the input features that the rank's activations hold.)"""
    from videoitg_tpu_torch.ops.quant import pack_int4, unpack_int4

    full = unpack_int4(packed)
    n = full.shape[-2]
    if n % (2 * tp):
        raise ValueError(f"int4 input dimension ({n}) does not split into packed "
                         f"halves over tp={tp}")
    step = n // tp
    return pack_int4(full.narrow(-2, rank * step, step))


def local_slice(name: str, tensor: torch.Tensor, spec: Spec, shape: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """The slice of a whole leaf that the rank at `coords` holds (a view,
    or a repacked copy for a row-parallel packed-int4 weight)."""
    if name.endswith(".w_q4") and spec[0] == TP_AXIS and shape.get(TP_AXIS, 1) > 1:
        return _int4_rows(tensor, shape[TP_AXIS], coords[TP_AXIS])
    return _slice(tensor, spec, shape, coords)


def shard_model(model: nn.Module, specs: Any, shape: Mapping[str, int],
                coords: Mapping[str, int], tp_group=None) -> nn.Module:
    """A copy of `model` that holds only this rank's slice of every leaf.

    `specs` is a spec tree (`grounding_param_specs`); `shape` the mesh's
    {axis: size}, `coords` this rank's {axis: index}. Under tp each sharded
    linear (and the vocab-sharded embedding) is marked with a `TPShard`
    carrying `tp_group`; under pp (`specs` built with pp=True) the LM keeps
    only this stage's decoder layers, [s L/P, (s+1) L/P), and records
    `pp_layers = (first, end)`. The input model is not changed; a leaf that
    is not split is shared with it, not copied. With tp and pp both 1 the
    model itself is returned."""
    tp, pp = shape.get(TP_AXIS, 1), shape.get(PP_AXIS, 1)
    if tp == 1 and pp == 1:
        return model
    flat = adapt_specs_to_params(specs, model)
    memo: Dict[int, Any] = {}
    lm_layers = getattr(getattr(model, "lm", None), "layers", None)
    stage = None
    pp_sharded = _spec_node(specs, ["lm", "layers", "0", "q"])[0]
    if pp > 1 and pp_sharded is not None and pp_sharded["w"][0] == PP_AXIS:
        n_layers = len(lm_layers)
        if n_layers % pp:
            raise ValueError(f"layers ({n_layers}) % pp ({pp}) != 0")
        per = n_layers // pp
        stage = (coords[PP_AXIS] * per, (coords[PP_AXIS] + 1) * per)
    for name, tensor in list(model.named_parameters()) + list(model.named_buffers()):
        if stage is not None and name.startswith("lm.layers."):
            idx = int(name.split(".")[2])
            if not stage[0] <= idx < stage[1]:
                memo[id(tensor)] = None  # dropped with its layer below
                continue
        part = local_slice(name, tensor.data, flat[name], shape, coords)
        if part.shape == tensor.shape:
            memo[id(tensor)] = tensor
            continue
        part = part.clone()
        memo[id(tensor)] = (nn.Parameter(part, requires_grad=tensor.requires_grad)
                            if isinstance(tensor, nn.Parameter) else part)
    out = copy.deepcopy(model, memo)
    if stage is not None:
        out.lm.layers = nn.ModuleList(list(out.lm.layers)[stage[0]:stage[1]])
        out.lm.pp_layers = stage
    if tp > 1:
        gathered = _gathered(out)
        for name, mod in out.named_modules():
            kind = _tp_kind(mod, name, flat, gathered)
            if kind is not None:
                mod.tp = TPShard(kind, coords[TP_AXIS], tp, tp_group)
    return out


def _tp_kind(mod: nn.Module, name: str, flat: Mapping[str, Spec], gathered: set):
    """The TPShard kind of a module from its weight's spec, or None."""
    prefix = f"{name}." if name else ""
    for leaf in ("w", "w_qt", "w_q4"):
        spec = flat.get(prefix + leaf)
        if spec is None or TP_AXIS not in spec:
            continue
        if leaf == "w_qt":
            spec = spec[::-1]
        if spec[-1] == TP_AXIS:
            return "col_gather" if name in gathered else "col"
        if spec[0] == TP_AXIS:
            # an embedding table has no bias slot; a row-parallel linear has one
            return "row" if hasattr(mod, "b") else "vocab"
    return None
