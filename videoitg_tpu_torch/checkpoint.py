"""Weight bridge between the JAX package's params pytree and the port's model.

The JAX package keeps parameters as nested dicts with per-layer weights
stacked on a leading axis ([L, ...]) and linear weights [in, out]. The
port's `GroundingModel` names its submodules after the same keys and keeps
the same [in, out] layout for dense weights, so the bridge only unstacks (or
restacks) the layer axis: `params_from_numpy(tree)` then
`params_to_numpy(model)` gives back the same numbers bit for bit.

Quantised linears cross too. A tree's `w_q` (int8 [in, out]) + `scale`, or
`w_q4` (packed int8 [in/2, out]) + `scale4`, with the optional `b` and the
structural `act_q` marker (a key whose value is None), becomes a
`QuantLinear` (ops/quant.py) and comes back under the same keys; int8 stays
int8. The port stores `w_q` transposed ([out, in]); the bridge transposes it
both ways, which moves bytes and changes none.

LoRA leaves (`lora_a`, `lora_b`, `lora_scale`, train/lora.py) cross both
ways on dense, `w_q` and `w_q4` linears, in their own dtype, bit for bit.

The tree's leaves must already be numpy arrays (`jax.tree.map(np.asarray,
params)` on the JAX side); this module imports no jax. Loading HF
safetensors waits until released weights are in the repository (ROADMAP
queue 1).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models.common import LORA_KEYS, set_lora
from videoitg_tpu_torch.models.grounding import GroundingModel
from videoitg_tpu_torch.ops.quant import QuantLinear

_LAYER_KEY = re.compile(r"^(.*\.layers)\.(\d+)\.(.*)$")


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def _quant_linear(leaves: dict, layer, dtype: torch.dtype) -> QuantLinear:
    """One `QuantLinear` from a quantised linear's leaves (layer i of a
    stacked linear, or the whole of an unstacked one when `layer` is None)."""
    def leaf(key):
        if leaves.get(key) is None:
            return None
        t = _to_tensor(leaves[key])
        return t if layer is None else t[layer]

    weight, scale = ("w_q", "scale") if "w_q" in leaves else ("w_q4", "scale4")
    unknown = set(leaves) - {weight, scale, "b", "act_q"}
    if scale not in leaves or unknown:
        raise KeyError(f"a quantised linear holds {weight}, {scale}, optionally b and act_q; "
                       f"got {sorted(leaves)}")
    b = leaf("b")
    b = None if b is None else b.to(dtype)
    act_q = "act_q" in leaves
    if "w_q" in leaves:
        return QuantLinear(w_qt=leaf("w_q").t().contiguous(), scale=leaf("scale"),
                           b=b, act_q=act_q)
    return QuantLinear(w_q4=leaf("w_q4").contiguous(), scale=leaf("scale4"), b=b, act_q=act_q)


def _set_submodule(model: torch.nn.Module, path: str, module: torch.nn.Module) -> None:
    *parents, leaf = path.split(".")
    node = model
    for key in parents:
        node = node[int(key)] if key.isdigit() else getattr(node, key)
    setattr(node, leaf, module)


def params_from_numpy(tree: dict, cfg: GroundingConfig, device=None,
                      dtype: torch.dtype = torch.float32) -> GroundingModel:
    """The JAX params pytree (numpy leaves) -> the port's GroundingModel."""
    flat = list(_flatten(tree))
    # LoRA leaves are attached after the model is built (they are not part
    # of a fresh model's state dict): parent path -> {leaf: array}.
    adapters: Dict[str, dict] = {}
    for path, arr in flat:
        parent, _, leaf = path.rpartition(".")
        if leaf in LORA_KEYS:
            adapters.setdefault(parent, {})[leaf] = arr
    flat = [(path, arr) for path, arr in flat if path.rpartition(".")[2] not in LORA_KEYS]
    quant_parents = {path.rpartition(".")[0] for path, _ in flat
                     if path.rpartition(".")[2] in ("w_q", "w_q4")}
    state: Dict[str, torch.Tensor] = {}
    quantised: Dict[str, dict] = {parent: {} for parent in quant_parents}
    for path, arr in flat:
        parent, _, leaf = path.rpartition(".")
        if parent in quant_parents:
            quantised[parent][leaf] = arr
            continue
        t = _to_tensor(arr)
        head, sep, rest = path.partition(".layers.")
        if sep:  # stacked [L, ...] -> one tensor per layer module
            for i in range(t.shape[0]):
                state[f"{head}.layers.{i}.{rest}"] = t[i]
        else:
            state[path] = t
    model = GroundingModel(cfg, device=device, dtype=dtype)
    replaced = []
    for parent, leaves in quantised.items():
        head, sep, rest = parent.partition(".layers.")
        weight = leaves["w_q"] if "w_q" in leaves else leaves["w_q4"]
        targets = ([(f"{head}.layers.{i}.{rest}", i) for i in range(weight.shape[0])]
                   if sep else [(parent, None)])
        for lin_path, layer in targets:
            lin = _quant_linear(leaves, layer, dtype)
            _set_submodule(model, lin_path, lin if device is None else lin.to(device))
            replaced.append(lin_path + ".")
    dense = {k for k in model.state_dict() if not k.startswith(tuple(replaced))}
    if dense != set(state):
        raise KeyError(f"params tree does not match the model: missing "
                       f"{sorted(dense - set(state))}, unexpected {sorted(set(state) - dense)}")
    model.load_state_dict(state, strict=False)
    for parent, leaves in adapters.items():
        if set(leaves) != set(LORA_KEYS):
            raise KeyError(f"{parent}: a LoRA adapter holds {LORA_KEYS}, got {sorted(leaves)}")
        a, b, scale = (_to_tensor(leaves[key]) for key in LORA_KEYS)
        head, sep, rest = parent.partition(".layers.")
        targets = ([(f"{head}.layers.{i}.{rest}", i) for i in range(a.shape[0])]
                   if sep else [(parent, None)])
        for lin_path, layer in targets:
            lin = model.get_submodule(lin_path)
            set_lora(lin, *((t if layer is None else t[layer]).clone().to(device)
                            for t in (a, b, scale)))
    return model


def _export_leaves(model: GroundingModel) -> Iterator[Tuple[str, object]]:
    """(path, array-or-None) pairs under the JAX package's key names."""
    for path, t in model.state_dict().items():
        parent, _, leaf = path.rpartition(".")
        t = t.detach().cpu()
        if leaf == "w_qt":  # stored [out, in]; the tree holds [in, out]
            path, t = f"{parent}.w_q", t.t()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).contiguous().numpy().copy()
        yield path, arr
    for path, module in model.named_modules():
        if isinstance(module, QuantLinear) and module.act_q:
            yield f"{path}.act_q", None


def params_to_numpy(model: GroundingModel) -> dict:
    """Inverse of `params_from_numpy`: a nested dict of numpy arrays with
    stacked [L, ...] layer leaves. bf16 weights come back as float32, int8
    weights as int8, and an `act_q` linear carries the key `act_q: None`."""
    stacked: Dict[str, Dict[int, object]] = {}
    flat: Dict[str, object] = {}
    for path, arr in _export_leaves(model):
        m = _LAYER_KEY.match(path)
        if m:
            stacked.setdefault(f"{m.group(1)}.{m.group(3)}", {})[int(m.group(2))] = arr
        else:
            flat[path] = arr
    for path, layers in stacked.items():
        first = layers[0]
        flat[path] = None if first is None else np.stack([layers[i] for i in range(len(layers))])
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree
