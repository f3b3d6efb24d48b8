"""The bf16 tp gap, witnessed by the reference itself.

The JAX package's own `run_step` in bf16 on tp4 and dp2 x tp2 of its 8-device
virtual CPU mesh, against its own step with no mesh from the same start; the
port's gloo steps on the same layouts against the port's step with no mesh.
Both on the same inputs, at preset("dryrun") (4 LM layers, 8 q / 4 kv heads:
every axis tp splits divides by 4, as `scripts/torch_mesh_check.py --train
--cpu 4` rehearses it; tiny's 2 kv heads do not split four ways in the port,
which splits whole heads), the base cast to bf16 and the adapters fp32 (the
train CLI's LoRA run on the card), the tower features in bf16, in two recipes:

* "train-opt": LoRA r4 and `TRAIN_OPT` of tests/_torch_train_mesh.py, its
  4-sample features batch for both layouts;
* "mesh-check": the recipe of `torch_mesh_check.py --train`: LoRA r16,
  `make_lora_optimizer(lr 2e-4, out_proj_lr 2e-4, total_steps 10)`, one
  16-frame sample (its 16 text slots full) per dp rank.

The first update of both has learning rate 0 (one warmup step), so the loss
after the first update is the third step's. Per recipe, layout and package:
the relative gap in grad_norm at the first step and in the loss after the
first update. The port reproduces the reference's rounding when its gaps are
of the size of the reference's: within RATIO of them, or under FLOOR.

One JAX mesh compile per recipe and layout, and one with no mesh per batch:
too much for Tier-1, so marked slow. Run it with
`pytest -m slow -s tests/test_torch_parallel_train_tp_bf16.py` (~4 min on
one core); it prints every gap.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from _torch_bridge import to_numpy_tree
from _torch_dist import (HW, TRAIN_OPT, bf16_base, grounding_samples, port_batch, run_world,
                         train_cfg)
from _torch_train_mesh import write_trees
from videoitg_tpu.config import preset as jax_preset
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.parallel.mesh import batch_sharding
from videoitg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from videoitg_tpu.parallel.sharding import (adapt_specs_to_params, grounding_param_specs,
                                            shard_params)
from videoitg_tpu.train import lora as jax_lora
from videoitg_tpu.train import train_step as jax_train_step
from videoitg_tpu.train.collate import collate_grounding as jax_collate
from videoitg_tpu.train.dataset import GroundingSample as JaxSample
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.train import lora, train_step

pytestmark = pytest.mark.slow

PRESET = "dryrun"
STEPS = 3
RATIO = 2.0
FLOOR = 2 ** -8  # one bf16 ulp, relative: below it a gap is one rounding of bf16 values
MESHES = {"tp4": dict(dp=1, tp=4), "dp2-tp2": dict(dp=2, tp=2)}
RECIPES = {
    "train-opt": dict(rank=4, opt=TRAIN_OPT, t_bucket=4,
                      batch=lambda dp: ("grounding", 1, "features", {})),
    "mesh-check": dict(rank=16, opt=dict(learning_rate=2e-4, out_proj_lr=2e-4, total_steps=10),
                       t_bucket=16,
                       batch=lambda dp: ("grounding", 31, "features",
                                         {"b": dp, "t_reals": (16,), "l_txt": (16,)})),
}


def layouts(recipe):
    r = RECIPES[recipe]
    return [dict(name=f"{recipe}:{name}", mesh=mesh, ranks=[0, 1, 2, 3], tree=recipe,
                 opt="lora", opt_kw=r["opt"], batch=r["batch"](mesh["dp"]),
                 t_bucket=r["t_bucket"], hw=HW, dtype="bfloat16", steps=STEPS, preset=PRESET)
            for name, mesh in MESHES.items()]


def jax_tree(rank):
    """The starting JAX params, fp32: init_grounding and LoRA of `rank`."""
    params = jax_init_grounding(jax.random.PRNGKey(0), jax_preset(PRESET), dtype=jnp.float32)
    return jax_lora.add_lora(params, jax.random.PRNGKey(1), rank=rank)


def bf16_tree(tree):
    """The JAX tree with its base in bf16 and its `lora_*` leaves as they are."""
    def cast(path, x):
        lora_leaf = any(str(getattr(k, "key", "")).startswith("lora_") for k in path)
        return x if lora_leaf or not jnp.issubdtype(x.dtype, jnp.floating) else \
            x.astype(jnp.bfloat16)
    return jax.tree_util.tree_map_with_path(cast, tree)


def jax_metrics(params, layout, mesh_kw=None):
    """[(loss, grad_norm) per step] of the JAX package's run_step on the
    layout's recipe, on a mesh of `mesh_kw` or with none."""
    _, seed, form, kw = layout["batch"]
    samples = [JaxSample(fr, ids, lab, "v") for fr, ids, lab
               in grounding_samples(train_cfg(name=PRESET), seed, form, **kw)]
    batch = jax_collate(samples, t_bucket=layout["t_bucket"], cfg=jax_preset(PRESET),
                        dtype=jnp.bfloat16)
    mesh = None
    if mesh_kw is None:
        batch = jax.tree.map(jnp.asarray, batch)
    else:
        mesh = jax_make_mesh(devices=jax.devices()[:math.prod(mesh_kw.values())], **mesh_kw)
        params = shard_params(params, adapt_specs_to_params(grounding_param_specs(), params),
                              mesh)
        batch = jax.tree.map(lambda a: jax.device_put(a, batch_sharding(mesh)), batch)
    tx = jax_lora.make_lora_optimizer(params, **layout["opt_kw"])
    step = jax_train_step.make_train_step(jax_preset(PRESET), tx, hw=HW, use_flash=False,
                                          remat=True)
    state = jax_train_step.create_train_state(params, tx)
    if mesh is not None:
        # the step returns its scalars on the mesh: put them there first, so the
        # later steps reuse the first one's compile
        replicated = NamedSharding(mesh, PartitionSpec())
        state = jax.tree.map(lambda x: jax.device_put(x, replicated) if x.ndim == 0 else x,
                             state)
    out = []
    for _ in range(STEPS):
        state, m = jax_train_step.run_step(step, state, batch, mesh=mesh)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def port_metrics(tree, layout):
    """[(loss, grad_norm) per step] of the port's run_step with no mesh."""
    cfg = train_cfg(name=PRESET)
    model = bf16_base(params_from_numpy(tree, cfg))
    tx = lora.make_lora_optimizer(model, **layout["opt_kw"])
    step_fn = train_step.make_train_step(cfg, tx, hw=HW, use_flash=False, remat=True)
    state = train_step.create_train_state(model, tx)
    batch = port_batch(cfg, layout["batch"], layout["t_bucket"], torch.bfloat16)
    out = []
    for _ in range(STEPS):
        state, m = train_step.run_step(step_fn, state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def gaps(got, want):
    """(relative grad_norm gap at the first step, relative loss gap after
    the first update)."""
    return abs(got[0][1] - want[0][1]) / want[0][1], abs(got[2][0] - want[2][0]) / abs(want[2][0])


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    trees = {name: jax_tree(r["rank"]) for name, r in RECIPES.items()}
    tmp = tmp_path_factory.mktemp("tp_bf16")
    every = [lay for name in RECIPES for lay in layouts(name)]
    outs = run_world(4, "train", tmp / "world", tree_paths=write_trees(tmp, trees),
                     layouts=every)
    out = {}
    for layout in every:
        tree = trees[layout["tree"]]
        port_none = port_metrics(to_numpy_tree(tree), layout)
        port_mesh = [(m["loss"], m["grad_norm"]) for m in outs[0][layout["name"]]["metrics"]]
        jax_none = jax_metrics(bf16_tree(tree), layout)
        jax_mesh = jax_metrics(bf16_tree(tree), layout, layout["mesh"])
        w = out[layout["name"]] = dict(jax=gaps(jax_mesh, jax_none),
                                       port=gaps(port_mesh, port_none),
                                       steps=(jax_none, jax_mesh, port_none, port_mesh))
        print(f"bf16 {layout['name']}: JAX grad_norm gap at the first step {w['jax'][0]:.4g}, "
              f"loss gap after the first update {w['jax'][1]:.4g}; port {w['port'][0]:.4g}, "
              f"{w['port'][1]:.4g}; (loss, grad_norm) per step: JAX no mesh {jax_none}, mesh "
              f"{jax_mesh}; port no mesh {port_none}, mesh {port_mesh}", flush=True)
    return out


@pytest.mark.parametrize("layout", [lay["name"] for name in RECIPES for lay in layouts(name)])
def test_port_gap_is_the_references(witness, layout):
    w = witness[layout]
    assert np.isfinite(np.asarray(w["steps"])).all()
    for what, jax_gap, port_gap in zip(("grad_norm", "loss"), w["jax"], w["port"]):
        assert port_gap <= max(RATIO * jax_gap, FLOOR), (what, port_gap, jax_gap)
