"""The port's weight sharding (videoitg_tpu_torch/parallel/sharding.py)
against the JAX package's `shard_params` on the 8-device virtual CPU mesh.

For each layout and each tree (dense, int8, the act8 tier, int4, LoRA), every
leaf that rank r keeps after `shard_model` equals, bit for bit, the JAX shard
that device r holds; the mesh layouts and rank coordinates are the JAX
meshes'. Two named differences: under pp the JAX tree replicates the LoRA
leaves of every layer onto every stage, where a port stage keeps the adapters
of its own layers (the same rows); and a row-parallel packed-int4 weight
(o, down) keeps its own input rows, repacked, where the JAX shard holds rows
of each half of the input axis: both are unpacked and held to the same rows
of the whole JAX weight, and the JAX shard to its own rows of it. No process
group is needed: `shard_model` is a pure function of the model, the specs and
the mesh coordinates.
"""

import numpy as np
import pytest
import torch

import jax

from _torch_bridge import by_port_name, tiny_params, to_numpy_tree
from videoitg_tpu.ops.quant import apply_full_int8, quantize_grounding_int8, quantize_qwen2_int4
from videoitg_tpu.parallel import sharding as jax_sharding
from videoitg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from videoitg_tpu.train import lora as jax_lora
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.config import preset as port_preset
from videoitg_tpu_torch.parallel import sharding
from videoitg_tpu_torch.parallel.mesh import mesh_layout

TREES = {
    "dense": lambda p: p,
    "int8": quantize_grounding_int8,
    "act8": apply_full_int8,
    "int4": lambda p: dict(p, lm=quantize_qwen2_int4(p["lm"])),
    "lora": lambda p: jax_lora.add_lora(p, jax.random.PRNGKey(3), rank=4),
}
LAYOUTS = {"dp2-tp4": dict(dp=2, tp=4), "pp2-dp2-tp2": dict(pp=2, dp=2, tp=2)}


def _device_trees(sharded, n):
    """Device index -> the tree of that device's shards (numpy)."""
    devices = jax.devices()[:n]

    def on(r):
        def leaf(a):
            if a is None:
                return None
            return next(np.asarray(s.data) for s in a.addressable_shards
                        if s.device == devices[r])
        return jax.tree.map(leaf, sharded, is_leaf=lambda x: x is None)
    return [on(r) for r in range(n)]


def _stage_adapters(want, stage, n_layers_per_stage):
    """The JAX tree keeps the (tiny) LoRA leaves of every layer on every pp
    stage, replicated; a port stage holds its own layers only, adapters
    included: keep the stage's rows of the stacked adapters."""
    out = {}
    for name, arr in want.items():
        head, sep, rest = name.partition("lm.layers.")
        if sep and rest.split(".")[-1].startswith("lora_"):
            i, tail = rest.split(".", 1)
            j = int(i) - stage * n_layers_per_stage
            if 0 <= j < n_layers_per_stage:
                out[f"lm.layers.{j}.{tail}"] = arr
        else:
            out[name] = arr
    return out


def _unpack_int4(a):
    """numpy int8 [in/2, out] -> [in, out]: low nibble row i, high row i + in/2."""
    return np.concatenate([((a & 0xF) ^ 8) - 8, a >> 4], axis=-2)


def _own_int4_rows(got, want, whole, coords, kw, per_stage):
    """Unpack the row-parallel int4 weights of `got` and `want`: the JAX
    shard of tp rank t must hold rows [t h, (t+1) h) of each half of the whole
    weight's input axis (h = in / 2 tp), the port's rank rows
    [t in/tp, (t+1) in/tp); `want` is replaced by the latter."""
    tp, t = kw["tp"], coords["tp"]
    for name in [n for n in want if n.endswith((".o.w_q4", ".down.w_q4"))]:
        j, rest = name[len("lm.layers."):].split(".", 1)
        rows = _unpack_int4(whole[f"lm.layers.{coords.get('pp', 0) * per_stage + int(j)}.{rest}"])
        n = rows.shape[0]
        h, step = n // (2 * tp), n // tp
        assert np.array_equal(_unpack_int4(want[name]),
                              np.concatenate([rows[t * h:(t + 1) * h],
                                              rows[n // 2 + t * h:n // 2 + (t + 1) * h]]))
        want[name] = rows[t * step:(t + 1) * step]
        got[name] = _unpack_int4(got[name])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_each_rank_keeps_the_jax_shard_of_device_r(layout, tree):
    kw = LAYOUTS[layout]
    pp = kw.get("pp", 1) > 1
    params = TREES[tree](tiny_params(seed=5))
    mesh = jax_make_mesh(devices=jax.devices()[:8], **kw)
    specs = jax_sharding.adapt_specs_to_params(
        jax_sharding.grounding_param_specs(pp=pp), params)
    per_device = _device_trees(jax_sharding.shard_params(params, specs, mesh), 8)

    axes, shape = mesh_layout(8, **kw)
    assert axes == tuple(mesh.axis_names) and shape == tuple(mesh.devices.shape)
    whole = by_port_name(to_numpy_tree(params))
    model = params_from_numpy(to_numpy_tree(params), port_preset("tiny"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    port_specs = sharding.grounding_param_specs(pp=pp)
    for r in range(8):
        coords = dict(zip(axes, (int(i) for i in np.unravel_index(r, shape))))
        local = sharding.shard_model(model, port_specs, dict(zip(axes, shape)), coords)
        want = by_port_name(per_device[r])
        if pp and tree == "lora":
            want = _stage_adapters(want, coords["pp"], 1)  # tiny: 2 layers, 2 stages
        got = {}
        for name, t in local.state_dict().items():
            if name.endswith(".w_qt"):
                name, t = name[:-5] + ".w_q", t.t()
            got[name] = t.numpy()
        if tree == "int4":
            _own_int4_rows(got, want, whole, coords, kw, 1 if pp else 2)  # tiny: 2 layers
        assert sorted(got) == sorted(want), r
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype and np.array_equal(got[name], arr), (r, name)
    # the input model is untouched
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_markers_say_which_collective_each_linear_needs():
    model = params_from_numpy(to_numpy_tree(tiny_params(seed=5)), port_preset("tiny"))
    local = sharding.shard_model(model, sharding.grounding_param_specs(), {"dp": 1, "tp": 2},
                                 {"dp": 0, "tp": 1})
    layer, tower = local.lm.layers[0], local.vision.layers[0]
    kinds = {name: getattr(getattr(layer, name), "tp").kind
             for name in ("q", "k", "v", "o", "gate", "up", "down")}
    assert kinds == {"q": "col", "k": "col", "v": "col", "o": "row", "gate": "col",
                     "up": "col", "down": "row"}
    assert (tower.fc1.tp.kind, tower.fc2.tp.kind, tower.o.tp.kind) == ("col", "row", "row")
    assert local.vision.patch_embed.tp.kind == "col_gather"
    assert (local.projector.fc1.tp.kind, local.projector.fc2.tp.kind) == ("col", "row")
    assert local.lm.embed.tp == sharding.TPShard("vocab", 1, 2, None)
    assert getattr(local.out_proj, "tp", None) is None
    # every axis 1: the model itself, unmarked
    assert sharding.shard_model(model, sharding.grounding_param_specs(),
                                {"dp": 1, "tp": 1}, {"dp": 0, "tp": 0}) is model


@pytest.mark.parametrize("n,kw", [(1, {}), (2, {}), (4, {}), (8, {}), (8, dict(dp=2)),
                                  (8, dict(tp=2)), (8, dict(sp=2)), (8, dict(pp=2)),
                                  (8, dict(pp=2, sp=2)), (6, {}), (8, dict(dp=2, tp=2, sp=2))])
def test_mesh_layout_is_the_jax_mesh(n, kw):
    """Axis names, order and sizes of `mesh_layout` equal JAX `make_mesh` on
    the same device count, defaults included; a layout JAX refuses is refused."""
    mesh = jax_make_mesh(devices=jax.devices()[:n], **kw)
    assert mesh_layout(n, **kw) == (tuple(mesh.axis_names), tuple(mesh.devices.shape))


@pytest.mark.parametrize("n,kw", [(8, dict(pp=3)), (8, dict(dp=3, tp=2)), (6, dict(sp=4))])
def test_mesh_layout_refuses_what_jax_refuses(n, kw):
    with pytest.raises(AssertionError):
        jax_make_mesh(devices=jax.devices()[:n], **kw)
    with pytest.raises(AssertionError):
        mesh_layout(n, **kw)
