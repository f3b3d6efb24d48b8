"""Weight bridge between the JAX package's params pytree and the port's model.

The JAX package keeps parameters as nested dicts with per-layer weights
stacked on a leading axis ([L, ...]) and linear weights [in, out]. The
port's `GroundingModel` names its submodules after the same keys and keeps
the same [in, out] layout, so the bridge only unstacks (or restacks) the
layer axis: `params_from_numpy(tree)` then `params_to_numpy(model)` gives
back the same numbers bit for bit.

The tree's leaves must already be numpy arrays (`jax.tree.map(np.asarray,
params)` on the JAX side); this module imports no jax. Quantised (`w_q`,
`w_q4`) and LoRA trees raise NotImplementedError. Loading HF safetensors
waits until released weights are in the repository (ROADMAP queue 1).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from videoitg_tpu.config import GroundingConfig
from videoitg_tpu_torch.models.grounding import GroundingModel

_LAYER_KEY = re.compile(r"^(.*\.layers)\.(\d+)\.(.*)$")

# Linear forms of the JAX package that the port does not run yet.
UNPORTED_LINEAR_KEYS = {
    "w_q": "the int8 weight-only / act8 tiers (ROADMAP queue 1, quantised tiers)",
    "w_q4": "the packed-int4 tier (ROADMAP queue 1, quantised tiers)",
    "lora_a": "LoRA adapters (ROADMAP queue 1, training)",
}


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


def params_from_numpy(tree: dict, cfg: GroundingConfig, device=None,
                      dtype: torch.dtype = torch.float32) -> GroundingModel:
    """The JAX params pytree (numpy leaves) -> the port's GroundingModel."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        leaf = path.rsplit(".", 1)[-1]
        if leaf in UNPORTED_LINEAR_KEYS:
            raise NotImplementedError(
                f"{path}: {UNPORTED_LINEAR_KEYS[leaf]} is not ported yet")
        t = _to_tensor(arr)
        head, sep, rest = path.partition(".layers.")
        if sep:  # stacked [L, ...] -> one tensor per layer module
            for i in range(t.shape[0]):
                state[f"{head}.layers.{i}.{rest}"] = t[i]
        else:
            state[path] = t
    model = GroundingModel(cfg, device=device, dtype=dtype)
    model.load_state_dict(state, strict=True)
    return model


def params_to_numpy(model: GroundingModel) -> dict:
    """Inverse of `params_from_numpy`: a nested dict of numpy arrays with
    stacked [L, ...] layer leaves. bf16 weights come back as float32."""
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    flat: Dict[str, np.ndarray] = {}
    for path, t in model.state_dict().items():
        t = t.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
        m = _LAYER_KEY.match(path)
        if m:
            stacked.setdefault(f"{m.group(1)}.{m.group(3)}", {})[int(m.group(2))] = arr
        else:
            flat[path] = arr
    for path, layers in stacked.items():
        flat[path] = np.stack([layers[i] for i in range(len(layers))])
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree
