"""Checkpoints: HF-format VideoITG directories, and the bridge from the JAX
package's params pytree.

HF format (counterpart of videoitg_tpu/checkpoint.py). A directory holds
`*.safetensors` files (sharded or not, `mm_projector.safetensors` for an
adapter save) or `*.bin` torch pickles, in the layout the reference trainer
writes, plus the self-describing `videoitg_tpu_config.json`.
`load_grounding_model` reads one into a `GroundingModel` on the requested
device and dtype, tensor by tensor: no whole-model copy is ever made on the
host. `save_hf_checkpoint` writes one back (fp32, as the JAX package does);
`convert_grounding_checkpoint` / `convert_vlm_checkpoint` /
`export_grounding_state_dict` are the conversions on an in-memory state dict.
Both directions go through one table, `hf_key_table`: HF name, the port's
state-dict key and the layout between them (a torch Linear's [out, in]
against the port's [in, out]; the patch conv's [O, C, kh, kw] against the
[kh*kw*C, O] matmul weight of models/siglip._patchify). Unknown or missing
keys raise and name the keys; only `_UNUSED` keys, which no module reads,
are passed over.

The safetensors codec is the port's own (`read_safetensors`,
`write_safetensors`): an 8-byte little-endian header length, a JSON header
of {name: {dtype, shape, data_offsets}} with an optional `__metadata__`,
then the raw little-endian bytes. It needs no `safetensors` package, which
the card's machine does not have, and reads BF16 straight into torch.

The numpy bridge. The JAX package keeps parameters as nested dicts with
per-layer weights stacked on a leading axis ([L, ...]) and linear weights
[in, out]. The port's `GroundingModel` names its submodules after the same
keys and keeps the same [in, out] layout for dense weights, so the bridge
only unstacks (or restacks) the layer axis: `params_from_numpy(tree)` then
`params_to_numpy(model)` gives back the same numbers bit for bit.

Quantised linears cross too. A tree's `w_q` (int8 [in, out]) + `scale`, or
`w_q4` (packed int8 [in/2, out]) + `scale4`, with the optional `b` and the
structural `act_q` marker (a key whose value is None), becomes a
`QuantLinear` (ops/quant.py) and comes back under the same keys; int8 stays
int8. The port stores `w_q` transposed ([out, in]); the bridge transposes it
both ways, which moves bytes and changes none.

A causal-VLM tree crosses too: an untied `lm.lm_head` ([hidden, vocab]) both
ways, and the scoring head `out_proj` only when the tree (or the model) has
one.

LoRA leaves (`lora_a`, `lora_b`, `lora_scale`, train/lora.py) cross both
ways on dense, `w_q` and `w_q4` linears, in their own dtype, bit for bit.

The tree's leaves must already be numpy arrays (`jax.tree.map(np.asarray,
params)` on the JAX side); this module imports no jax.

Serving checkpoints (counterpart of the JAX package's, which keep the tree in
an orbax `params/` directory; orbax loads jax). `save_serving_checkpoint`
writes `serving_config.json` byte for byte as the JAX writer does, the
tokenizer files, and `params.safetensors`: the same tree's leaves under their
dotted paths (`lm.layers.q.w_q`, stacked [L, ...]), each in the dtype the
model holds, streamed one layer at a time, with the `act_q` markers listed in
the file's metadata. `load_serving_checkpoint` builds the model on the meta
device and fills it layer by layer from the file: the quantised form is read
as it was saved, with no dense copy and no second quantisation. Both this
loader and `params_from_numpy` go through `_assemble`.
"""

from __future__ import annotations

import json
import os
import re
import struct
import sys
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from videoitg_tpu_torch.config import GroundingConfig
from videoitg_tpu_torch.models.common import LORA_KEYS, has_lora, set_lora
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


def _take(src, layer: Optional[int], device, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """Layer `layer` of a stacked leaf, or the whole leaf when `layer` is None,
    as a tensor of its own on `device` (floating leaves cast to `dtype` when
    one is given). `src` is a tensor, or a `_TensorRef` into a file, of which
    only the bytes of that layer are read."""
    if isinstance(src, _TensorRef):
        t = (src if layer is None else src.layer(layer)).read()
    else:
        t = src if layer is None else src[layer]
    cast = dtype if dtype is not None and t.is_floating_point() else None
    return t.to(device=device, dtype=cast, copy=True)


def _quant_linear(leaves: dict, layer: Optional[int], device,
                  dtype: Optional[torch.dtype]) -> QuantLinear:
    """One `QuantLinear` from a quantised linear's leaves (layer i of a
    stacked linear, or the whole of an unstacked one when `layer` is None);
    the bias is cast to `dtype` when one is given."""
    weight, scale = ("w_q", "scale") if "w_q" in leaves else ("w_q4", "scale4")
    unknown = set(leaves) - {weight, scale, "b", "act_q"}
    if scale not in leaves or unknown:
        raise KeyError(f"a quantised linear holds {weight}, {scale}, optionally b and act_q; "
                       f"got {sorted(leaves)}")
    b = None if leaves.get("b") is None else _take(leaves["b"], layer, device, dtype)
    act_q = "act_q" in leaves
    w, s = _take(leaves[weight], layer, device), _take(leaves[scale], layer, device)
    if weight == "w_q":
        return QuantLinear(w_qt=w.t().contiguous(), scale=s, b=b, act_q=act_q)
    return QuantLinear(w_q4=w, scale=s, b=b, act_q=act_q)


def _set_submodule(model: torch.nn.Module, path: str, module: torch.nn.Module) -> None:
    *parents, leaf = path.split(".")
    node = model
    for key in parents:
        node = node[int(key)] if key.isdigit() else getattr(node, key)
    setattr(node, leaf, module)


def _layer_targets(path: str, src) -> List[Tuple[str, Optional[int]]]:
    """(the port's module or tensor path, layer) for each layer a leaf of the
    JAX tree fills: one per layer of a stacked `*.layers.*` leaf."""
    head, sep, rest = path.partition(".layers.")
    if not sep:
        return [(path, None)]
    return [(f"{head}.layers.{i}.{rest}", i) for i in range(src.shape[0])]


def _assemble(leaves: Mapping[str, object], cfg: GroundingConfig, device,
              dtype: Optional[torch.dtype]) -> GroundingModel:
    """The port's model from the JAX tree's leaves under their dotted paths
    (`lm.layers.q.w_q`: tensors or `_TensorRef`s, stacked [L, ...] under
    `*.layers.*`; an `act_q` marker's value is None). The model is built on
    the meta device and every tensor is put in place as it is read, so no
    dense copy of a quantised linear and no second copy of the model is
    made. Dense floating leaves and quantised biases are cast to `dtype`,
    or keep their own dtype when it is None; integer weights, scales and
    LoRA leaves always keep theirs."""
    adapters: Dict[str, dict] = {}
    quantised: Dict[str, dict] = {}
    dense: Dict[str, object] = {}
    quant_parents = {path.rpartition(".")[0] for path in leaves
                     if path.rpartition(".")[2] in ("w_q", "w_q4")}
    for path, src in leaves.items():
        parent, _, leaf = path.rpartition(".")
        if leaf in LORA_KEYS:
            adapters.setdefault(parent, {})[leaf] = src
        elif parent in quant_parents:
            quantised.setdefault(parent, {})[leaf] = src
        else:
            dense[path] = src
    # A causal-VLM tree may carry an untied `lm.lm_head` and may lack the
    # scoring head; the model is built to the tree.
    model = GroundingModel(cfg, device="meta", dtype=dtype or torch.float32,
                           with_lm_head=any(p.startswith("lm.lm_head.") for p in leaves),
                           with_out_proj=any(p.startswith("out_proj.") for p in leaves))
    replaced = []
    for parent, group in quantised.items():
        weight = group["w_q"] if "w_q" in group else group["w_q4"]
        for lin_path, layer in _layer_targets(parent, weight):
            _set_submodule(model, lin_path, _quant_linear(group, layer, device, dtype))
            replaced.append(lin_path + ".")
    state = {key: (src, layer) for path, src in dense.items()
             for key, layer in _layer_targets(path, src)}
    wanted = {k for k in model.state_dict() if not k.startswith(tuple(replaced))}
    if wanted != set(state):
        raise KeyError(f"params tree does not match the model: missing "
                       f"{sorted(wanted - set(state))}, unexpected {sorted(set(state) - wanted)}")
    model.load_state_dict({key: _take(src, layer, device, dtype)
                           for key, (src, layer) in state.items()}, strict=False, assign=True)
    for parent, group in adapters.items():
        if set(group) != set(LORA_KEYS):
            raise KeyError(f"{parent}: a LoRA adapter holds {LORA_KEYS}, got {sorted(group)}")
        for lin_path, layer in _layer_targets(parent, group["lora_a"]):
            set_lora(model.get_submodule(lin_path),
                     *(_take(group[key], layer, device) for key in LORA_KEYS))
    return model


def params_from_numpy(tree: dict, cfg: GroundingConfig, device=None,
                      dtype: torch.dtype = torch.float32) -> GroundingModel:
    """The JAX params pytree (numpy leaves) -> the port's GroundingModel on
    `device` (default: the CPU) in `dtype`."""
    leaves = {path: None if arr is None else _to_tensor(arr) for path, arr in _flatten(tree)}
    return _assemble(leaves, cfg, torch.device("cpu") if device is None else device, dtype)


def _jax_leaves(model: GroundingModel) -> Dict[str, object]:
    """Every leaf of the model under its path in the JAX tree, where the
    tensor lives and in its own dtype: an unstacked leaf as its tensor, a
    `*.layers.*` leaf as the list of its layers' tensors (to be stacked
    [L, ...]), an `act_q` marker as None (a list of Nones when stacked)."""
    named = [(path, t.detach()) for path, t in model.state_dict().items()]
    named = [(f"{path[:-5]}.w_q", t.t()) if path.endswith(".w_qt") else (path, t)
             for path, t in named]  # the port stores w_q [out, in]; the tree [in, out]
    named += [(f"{path}.act_q", None) for path, module in model.named_modules()
              if isinstance(module, QuantLinear) and module.act_q]
    leaves: Dict[str, object] = {}
    stacked: Dict[str, Dict[int, Optional[torch.Tensor]]] = {}
    for path, t in named:
        m = _LAYER_KEY.match(path)
        if m:
            stacked.setdefault(f"{m.group(1)}.{m.group(3)}", {})[int(m.group(2))] = t
        else:
            leaves[path] = t
    for path, layers in stacked.items():
        kinds = {None if t is None else (t.dtype, tuple(t.shape)) for t in layers.values()}
        if sorted(layers) != list(range(len(layers))) or len(kinds) != 1:
            raise ValueError(f"{path}: the layers differ in presence, dtype or shape, which a "
                             "stacked leaf cannot hold")
        leaves[path] = [layers[i] for i in range(len(layers))]
    return leaves


def params_to_numpy(model: GroundingModel) -> dict:
    """Inverse of `params_from_numpy`: a nested dict of numpy arrays with
    stacked [L, ...] layer leaves. bf16 weights come back as float32, int8
    weights as int8, and an `act_q` linear carries the key `act_q: None`."""
    def numpy(t: torch.Tensor) -> np.ndarray:
        t = t.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).contiguous().numpy().copy()

    tree: dict = {}
    for path, value in _jax_leaves(model).items():
        if isinstance(value, list):
            value = None if value[0] is None else np.stack([numpy(t) for t in value])
        elif value is not None:
            value = numpy(value)
        node = tree
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


# ---- safetensors ----

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {dtype: name for name, dtype in _ST_DTYPES.items()}


def _check_little_endian() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("the safetensors codec reads and writes little-endian hosts only")


class _TensorRef:
    """Where one tensor of a safetensors file lies: (path, dtype, shape, byte range)."""

    __slots__ = ("path", "dtype", "shape", "start", "stop")

    def __init__(self, path, dtype, shape, start, stop):
        self.path, self.dtype, self.shape, self.start, self.stop = path, dtype, shape, start, stop

    def layer(self, i: int) -> "_TensorRef":
        """Where row `i` of the first axis lies: a stacked leaf's layer i."""
        per = (self.stop - self.start) // self.shape[0]
        return _TensorRef(self.path, self.dtype, self.shape[1:], self.start + i * per,
                          self.start + (i + 1) * per)

    def read(self) -> torch.Tensor:
        buf = bytearray(self.stop - self.start)
        with open(self.path, "rb") as f:
            f.seek(self.start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{self.path}: file ends inside a tensor")
        if not buf:
            return torch.empty(self.shape, dtype=self.dtype)
        return torch.frombuffer(buf, dtype=self.dtype).reshape(self.shape)


def _safetensors_index(path: str) -> Tuple[Dict[str, _TensorRef], Optional[dict]]:
    """name -> `_TensorRef` of every tensor in the file, and its metadata."""
    _check_little_endian()
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None)
    base = 8 + n
    refs = {}
    for name, entry in header.items():
        if entry["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {entry['dtype']}, which the codec "
                             f"does not read (one of {sorted(_ST_DTYPES)})")
        dtype, shape = _ST_DTYPES[entry["dtype"]], tuple(entry["shape"])
        start, stop = entry["data_offsets"]
        numel = int(np.prod(shape, dtype=np.int64))
        if stop - start != numel * dtype.itemsize:
            raise ValueError(f"{path}: {name} spans {stop - start} bytes, its shape {shape} "
                             f"and dtype {entry['dtype']} need {numel * dtype.itemsize}")
        refs[name] = _TensorRef(path, dtype, shape, base + start, base + stop)
    return refs, metadata


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, on the CPU in its own dtype."""
    return {name: ref.read() for name, ref in _safetensors_index(path)[0].items()}


def write_safetensors(path: str, entries, metadata: Optional[Dict[str, str]] = None) -> int:
    """Write a safetensors file from `entries`: (name, dtype, shape, make)
    tuples, `make()` giving the tensor when its turn comes, so that only one
    tensor at a time is staged on the host. `make()` may instead give the
    rows of the first axis one at a time (an iterable of tensors of shape
    `shape[1:]`), so that a stacked leaf is staged one layer at a time.
    Returns the bytes written."""
    _check_little_endian()
    header, offset = {}, 0
    for name, dtype, shape, _ in entries:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        header[name] = {"dtype": _ST_NAMES[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name, dtype, shape, make in entries:
            made = make()
            whole = isinstance(made, torch.Tensor)
            rows = 0
            for t in [made] if whole else made:
                # Cast and lay out where the tensor lives (the card, for a
                # model there), then copy the packed bytes to the host.
                t = t.detach().to(dtype).contiguous().cpu()
                want = tuple(shape) if whole else tuple(shape[1:])
                if tuple(t.shape) != want:
                    raise ValueError(f"{name}: made {tuple(t.shape)}, announced {want}")
                if t.numel():
                    f.write(t.reshape(-1).view(torch.uint8).numpy().data)
                rows += 1
            if not whole and rows != shape[0]:
                raise ValueError(f"{name}: made {rows} rows, announced {shape[0]}")
    return 8 + len(text) + offset


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """Write `tensors` (any device, each in its own dtype) as one file."""
    return write_safetensors(path, [(name, t.dtype, tuple(t.shape), lambda t=t: t)
                                    for name, t in tensors.items()], metadata)


class HFStateDict(Mapping):
    """The tensors of the safetensors files of a checkpoint directory, read
    from disk one at a time when asked for (CPU, the file's dtype)."""

    def __init__(self, refs: Dict[str, _TensorRef]):
        self._refs = refs

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._refs[name].read()

    def __iter__(self):
        return iter(self._refs)

    def __len__(self) -> int:
        return len(self._refs)


def load_hf_state_dict(model_dir: str) -> Mapping[str, torch.Tensor]:
    """Every `*.safetensors` of `model_dir` in sorted order (shards and
    `mm_projector.safetensors` alike; a later file's key wins), read lazily;
    with none, every `*.bin` through `torch.load(weights_only=True)`."""
    names = sorted(os.listdir(model_dir))
    st_files = [f for f in names if f.endswith(".safetensors")]
    if st_files:
        refs: Dict[str, _TensorRef] = {}
        for fname in st_files:
            refs.update(_safetensors_index(os.path.join(model_dir, fname))[0])
        return HFStateDict(refs)
    bin_files = [f for f in names if f.endswith(".bin")]
    if bin_files:
        sd: Dict[str, torch.Tensor] = {}
        for fname in bin_files:
            sd.update(torch.load(os.path.join(model_dir, fname), map_location="cpu",
                                 weights_only=True))
        return sd
    raise FileNotFoundError(f"no safetensors/bin weights under {model_dir}")


# ---- HF names <-> the port's state-dict keys ----

CONFIG_NAME = "videoitg_tpu_config.json"
SERVING_CONFIG_NAME = "serving_config.json"
_VISION = "model.vision_tower.vision_tower.vision_model."
# Port module path -> HF module path (the reference's EagleQwenG layout; HF
# CLIP spells its pre-layernorm "pre_layrnorm").
_MODULES = (
    (r"lm\.embed", "model.embed_tokens"),
    (r"lm\.final_norm", "model.norm"),
    (r"lm\.lm_head", "lm_head"),
    (r"lm\.layers\.(\d+)\.input_norm", r"model.layers.\1.input_layernorm"),
    (r"lm\.layers\.(\d+)\.post_attn_norm", r"model.layers.\1.post_attention_layernorm"),
    (r"lm\.layers\.(\d+)\.(q|k|v|o)", r"model.layers.\1.self_attn.\2_proj"),
    (r"lm\.layers\.(\d+)\.(gate|up|down)", r"model.layers.\1.mlp.\2_proj"),
    (r"vision\.patch_embed", _VISION + "embeddings.patch_embedding"),
    (r"vision\.pre_ln", _VISION + "pre_layrnorm"),
    (r"vision\.layers\.(\d+)\.ln(1|2)", _VISION + r"encoder.layers.\1.layer_norm\2"),
    (r"vision\.layers\.(\d+)\.(q|k|v)", _VISION + r"encoder.layers.\1.self_attn.\2_proj"),
    (r"vision\.layers\.(\d+)\.o", _VISION + r"encoder.layers.\1.self_attn.out_proj"),
    (r"vision\.layers\.(\d+)\.(fc1|fc2)", _VISION + r"encoder.layers.\1.mlp.\2"),
    (r"out_proj", "out_proj"),
)
_PARAMS = {"vision.pos_embed": _VISION + "embeddings.position_embedding.weight",
           "vision.cls_embed": _VISION + "embeddings.class_embedding"}
# Keys of a reference checkpoint that no module of the model reads: SigLIP's
# post-layernorm and attention-pool head (the features are taken before
# them), and the position-id and RoPE buffers older transformers saved.
_UNUSED = re.compile(r"^" + re.escape(_VISION) + r"(post_layernorm|head)\.|"
                     r"\.(position_ids|rotary_emb\.inv_freq)$")


def _projector_module(fc: int, projector_type: str) -> str:
    """HF module of the port's `projector.fc{fc}` (the reference projector factory's
    layouts): seq_mlp `out_projection.{0,2}`, linear a bare Linear,
    mlpNx_gelu Sequential indices 0, 2, 4..."""
    if projector_type == "seq_mlp":
        return f"model.mm_projector.out_projection.{2 * (fc - 1)}"
    if projector_type == "linear":
        return "model.mm_projector"
    return f"model.mm_projector.{2 * (fc - 1)}"


def _hf_entry(key: str, cfg: GroundingConfig) -> Tuple[str, str]:
    """(HF name, layout) of one of the port's state-dict keys. Layouts:
    "same"; "linear", a torch Linear's [out, in] against the port's
    [in, out]; "patch", the conv kernel [O, C, kh, kw] against [kh*kw*C, O]."""
    if key in _PARAMS:
        return _PARAMS[key], "same"
    module, _, leaf = key.rpartition(".")
    m = re.fullmatch(r"projector\.fc(\d+)", module)
    if m:
        hf_module = _projector_module(int(m.group(1)), cfg.projector.projector_type)
    else:
        for pattern, template in _MODULES:
            m = re.fullmatch(pattern, module)
            if m:
                hf_module = m.expand(template)
                break
        else:
            raise KeyError(f"{key}: no HF name (quantised, LoRA or unknown parameter)")
    if leaf not in ("w", "b", "scale", "bias"):
        raise KeyError(f"{key}: no HF name (quantised, LoRA or unknown parameter)")
    if leaf in ("b", "bias"):
        return f"{hf_module}.bias", "same"
    layout = ("same" if leaf == "scale" or module == "lm.embed"
              else "patch" if module == "vision.patch_embed" else "linear")
    return f"{hf_module}.weight", layout


def hf_key_table(model: GroundingModel, cfg: GroundingConfig) -> List[Tuple[str, str, str]]:
    """(HF name, the port's state-dict key, layout) for every tensor of
    `model`: the one table both directions use."""
    table = []
    for key in model.state_dict():
        hf, layout = _hf_entry(key, cfg)
        table.append((hf, key, layout))
    return table


def _from_hf(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "linear":
        return t.t()
    if layout == "patch":  # [O, C, kh, kw] -> [kh, kw, C, O] -> [kh*kw*C, O]
        return t.permute(2, 3, 1, 0).reshape(-1, t.shape[0])
    return t


def _to_hf(t: torch.Tensor, layout: str, cfg: GroundingConfig) -> torch.Tensor:
    if layout == "linear":
        return t.t()
    if layout == "patch":  # [kh*kw*C, O] -> [O, C, kh, kw]
        p = cfg.vision.patch_size
        return t.reshape(p, p, -1, t.shape[1]).permute(3, 2, 0, 1)
    return t


def _load_into(model: GroundingModel, sd: Mapping[str, torch.Tensor],
               cfg: GroundingConfig) -> GroundingModel:
    """Fill `model` from the HF state dict `sd`, tensor by tensor: each one
    goes to the model's device, changes layout there and is cast into its
    parameter."""
    table = hf_key_table(model, cfg)
    wanted = {hf for hf, _, _ in table}
    has_head = hasattr(model.lm, "lm_head")
    unexpected = sorted(k for k in sd if k not in wanted and not _UNUSED.search(k)
                        and not (k == "lm_head.weight" and not has_head))
    missing = sorted(wanted - set(sd))
    if missing or unexpected:
        raise KeyError(f"checkpoint does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    params = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for hf, key, layout in table:
            dst = params[key]
            src = _from_hf(torch.as_tensor(sd[hf]).to(dst.device), layout)
            if src.shape != dst.shape:
                raise ValueError(f"{hf} {tuple(sd[hf].shape)} does not fit {key} "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    return model


def _device(device) -> torch.device:
    """The card unless the caller names another device."""
    return torch.device("cuda" if device is None else device)


def convert_grounding_checkpoint(sd: Mapping[str, torch.Tensor], cfg: GroundingConfig,
                                 device=None, dtype: torch.dtype = torch.float32
                                 ) -> GroundingModel:
    """A full EagleQwenG HF state dict -> the port's GroundingModel on
    `device` (default: the card) in `dtype`."""
    model = GroundingModel(cfg, device=_device(device), dtype=dtype)
    return _load_into(model, sd, cfg)


def convert_vlm_checkpoint(sd: Mapping[str, torch.Tensor], cfg: GroundingConfig,
                           device=None, dtype: torch.dtype = torch.float32) -> GroundingModel:
    """A causal Eagle-style VLM state dict (EagleQwenForCausalLM layout) ->
    the port's model for models/vlm.py: `lm_head` when the config is untied
    (a tied config reads the embedding instead), and the scoring head
    `out_proj` only when the checkpoint has one."""
    model = GroundingModel(cfg, device=_device(device), dtype=dtype, with_lm_head=True,
                           with_out_proj="out_proj.weight" in sd)
    return _load_into(model, sd, cfg)


def read_config(model_dir: str) -> GroundingConfig:
    """The checkpoint's `videoitg_tpu_config.json`, else VideoITG-8B."""
    path = os.path.join(model_dir, CONFIG_NAME)
    if not os.path.exists(path):
        return GroundingConfig.videoitg_8b()
    with open(path) as f:
        return GroundingConfig.from_json(f.read())


def load_grounding_model(model_dir: str, cfg: Optional[GroundingConfig] = None, device=None,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[GroundingModel, GroundingConfig]:
    """An HF-format VideoITG checkpoint directory -> (model, cfg), the model
    on `device` (default: the card) in `dtype`. The config is `cfg` when
    given, else the directory's videoitg_tpu_config.json, else VideoITG-8B."""
    cfg = cfg or read_config(model_dir)
    return convert_grounding_checkpoint(load_hf_state_dict(model_dir), cfg, device, dtype), cfg


# ---- serving checkpoints (pre-quantised, fast cold start) ----

SERVING_FORMAT = "videoitg-serving-v1"
SERVING_PARAMS_NAME = "params.safetensors"
_TOKENIZER_FILES = ("tokenizer*", "special_tokens_map.json", "vocab*", "merges.txt")


def is_serving_checkpoint(model_dir: str) -> bool:
    """A directory written by `save_serving_checkpoint`, of either package."""
    return os.path.exists(os.path.join(model_dir, SERVING_CONFIG_NAME))


def _serving_entries(model: GroundingModel) -> Tuple[list, List[str]]:
    """`write_safetensors` entries of every leaf of the model under its JAX
    path, a stacked `*.layers.*` leaf as [L, ...] made one layer at a time,
    in the dtype the model holds; and the paths of the `act_q` markers."""
    entries, markers = [], []
    for path, value in _jax_leaves(model).items():
        first = value[0] if isinstance(value, list) else value
        if first is None:
            markers.append(path)
        elif isinstance(value, list):
            entries.append((path, first.dtype, (len(value), *first.shape),
                            lambda value=value: iter(value)))
        else:
            entries.append((path, value.dtype, tuple(value.shape), lambda value=value: value))
    return entries, markers


def save_serving_checkpoint(model: GroundingModel, cfg: GroundingConfig, out_dir: str,
                            quantize: Optional[str] = None,
                            tokenizer_dir: Optional[str] = None) -> str:
    """Persist a ready-to-serve model (int8 / int4 linears, LoRA adapters
    and all) so that a later load skips the HF convert and the
    quantisation pass. Layout: `serving_config.json` as the JAX package
    writes it (format, tier, config), the tokenizer files of
    `tokenizer_dir`, and `params.safetensors`, every leaf under its dotted
    JAX path (`lm.layers.q.w_q` [L, in, out] int8) in the dtype the model
    holds, with the `act_q` markers listed in its metadata (the JAX package
    keeps the same tree in an orbax `params/` directory). Leaves are staged
    on the host one layer at a time. Returns the directory."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, SERVING_CONFIG_NAME), "w") as f:
        json.dump({"format": SERVING_FORMAT, "quantize": quantize,
                   "config": json.loads(cfg.to_json())}, f, indent=2)
    if tokenizer_dir:
        # Carry the tokenizer so the directory is self-contained.
        import glob
        import shutil

        for pattern in _TOKENIZER_FILES:
            for name in glob.glob(os.path.join(tokenizer_dir, pattern)):
                shutil.copy(name, out_dir)
    entries, markers = _serving_entries(model)
    write_safetensors(os.path.join(out_dir, SERVING_PARAMS_NAME), entries,
                      metadata={"format": "pt", "act_q": json.dumps(markers)})
    return out_dir


def load_serving_checkpoint(model_dir: str, device=None
                            ) -> Tuple[GroundingModel, GroundingConfig, Optional[str]]:
    """(model, cfg, quantisation tier) of a `save_serving_checkpoint`
    directory, the model on `device` (default: the card) in the form and
    dtypes it was saved in, read one layer at a time. A directory of the
    JAX package (an orbax `params/` tree) is refused: the port reads no
    orbax."""
    with open(os.path.join(model_dir, SERVING_CONFIG_NAME)) as f:
        meta = json.load(f)
    if meta.get("format") != SERVING_FORMAT:
        raise ValueError(f"{model_dir}: serving format {meta.get('format')!r}, "
                         f"expected {SERVING_FORMAT!r}")
    path = os.path.join(model_dir, SERVING_PARAMS_NAME)
    if not os.path.exists(path):
        what = ("the JAX package's serving layout (an orbax params/ tree), which the port "
                "does not read" if os.path.isdir(os.path.join(model_dir, "params"))
                else f"no {SERVING_PARAMS_NAME}")
        raise FileNotFoundError(
            f"{model_dir} holds {what}; re-export it from its HF-format checkpoint with "
            "`videoitg-torch-select --model HF_DIR [--quantize TIER] --export-serving DIR`")
    cfg = GroundingConfig.from_json(json.dumps(meta["config"]))
    refs, metadata = _safetensors_index(path)
    leaves: Dict[str, object] = dict(refs)
    leaves.update((marker, None) for marker in json.loads((metadata or {}).get("act_q", "[]")))
    return _assemble(leaves, cfg, _device(device), None), cfg, meta.get("quantize")


def _export_entries(model: GroundingModel, cfg: GroundingConfig
                    ) -> List[Tuple[str, Tuple[int, ...], Callable[[], torch.Tensor]]]:
    """(HF name, shape, make) of every tensor of the export, fp32 on make."""
    for path, module in model.named_modules():
        if isinstance(module, QuantLinear):
            raise ValueError(f"{path}: export requires unquantized weights")
        if hasattr(module, "lora_a") and has_lora(module):
            raise ValueError(f"{path}: export requires merged LoRA adapters "
                             "(train/lora.merge_lora)")
    params = model.state_dict()
    entries = []
    for hf, key, layout in hf_key_table(model, cfg):
        shape = tuple(_to_hf(torch.empty(params[key].shape, device="meta"), layout, cfg).shape)
        entries.append((hf, shape, lambda key=key, layout=layout:
                        _to_hf(params[key], layout, cfg).float()))
    return entries


def export_grounding_state_dict(model: GroundingModel, cfg: GroundingConfig
                                ) -> Dict[str, torch.Tensor]:
    """The model -> a reference-layout HF state dict of fp32 CPU tensors:
    the inverse of `convert_grounding_checkpoint` (and, with an `lm_head`,
    of `convert_vlm_checkpoint`)."""
    return {hf: make().cpu().contiguous() for hf, _, make in _export_entries(model, cfg)}


def save_hf_checkpoint(model: GroundingModel, cfg: GroundingConfig, out_dir: str,
                       projector_only: bool = False) -> str:
    """Write `model.safetensors` (fp32) and `videoitg_tpu_config.json` into
    `out_dir`; with `projector_only`, `mm_projector.safetensors` with the
    `model.mm_projector.*` and `out_proj.*` tensors only (the reference's
    adapter save). Tensors are staged on the host one at a time. Returns
    the weights file's path."""
    entries = _export_entries(model, cfg)
    if projector_only:
        entries = [e for e in entries if e[0].startswith(("model.mm_projector.", "out_proj"))]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "mm_projector.safetensors" if projector_only
                        else "model.safetensors")
    write_safetensors(path, [(hf, torch.float32, shape, make) for hf, shape, make in entries],
                      metadata={"format": "pt"})
    with open(os.path.join(out_dir, CONFIG_NAME), "w") as f:
        f.write(cfg.to_json())
    return path
