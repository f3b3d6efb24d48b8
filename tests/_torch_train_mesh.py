"""The JAX side of tests/test_torch_parallel_train*.py: the JAX package's
`run_step` on its 8-device virtual mesh for a layout of
`_torch_dist.train_job`, the JAX gradients of the same steps with no mesh,
and each port rank's expected slices of both.

Each layout is a dict: "name", "mesh" (make_mesh kwargs, the same in both
packages), "ranks" (the port ranks it runs on, None for the whole world),
"tree" (a key of `trees`), "opt" ("full" or "lora"), "batch" (objective,
seed, form, kwargs), "use_flash", "microbatches", and "hw" and "t_bucket" where
they differ from `_torch_dist.HW` and `T_BUCKET`.
"""

import dataclasses
import functools
import math
import pickle

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from _torch_bridge import by_port_name, to_numpy_tree
from _torch_dist import (HW, T_BUCKET, TRAIN_OPT, VLM_PAD, grounding_samples, run_world,
                         train_cfg, vlm_samples)
from videoitg_tpu.config import GroundingConfig as JaxConfig
from videoitg_tpu.models.grounding import grounding_loss as jax_grounding_loss
from videoitg_tpu.models.grounding import init_grounding as jax_init_grounding
from videoitg_tpu.models.vlm import vlm_loss as jax_vlm_loss
from videoitg_tpu.parallel.mesh import batch_sharding
from videoitg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from videoitg_tpu.parallel.sharding import (adapt_specs_to_params, grounding_param_specs,
                                            shard_params)
from videoitg_tpu.train import lora as jax_lora
from videoitg_tpu.train import optimizer as jax_optimizer
from videoitg_tpu.train import train_step as jax_train_step
from videoitg_tpu.train import vlm_sft as jax_sft
from videoitg_tpu.train.collate import collate_grounding as jax_collate
from videoitg_tpu.train.dataset import GroundingSample as JaxSample
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.parallel import sharding
from videoitg_tpu_torch.train import lora, optimizer

LOSS_RTOL = 1e-5
LEAF_ATOL = 2e-5


def jax_cfg(objective="grounding", layers=4):
    cfg = JaxConfig.tiny()
    lm = dataclasses.replace(cfg.lm, num_layers=layers)
    if objective == "vlm":
        lm = dataclasses.replace(lm, causal=True, tie_word_embeddings=True)
    return dataclasses.replace(cfg, lm=lm)


def jax_tree(objective="grounding", opt="full", quant=None, seed=0, trained_b=False):
    """The starting JAX params: init_grounding, int8 base with `quant`,
    LoRA r4 with opt "lora". `trained_b`: every lora_b drawn from N(0, 0.02^2)
    instead of zeros, as after some training, so the scales and the b leaves
    get gradients at the first step."""
    params = jax_init_grounding(jax.random.PRNGKey(seed), jax_cfg(objective), dtype=jnp.float32)
    if quant == "int8":
        from videoitg_tpu.ops.quant import quantize_grounding_int8

        params = quantize_grounding_int8(params)
    if opt == "lora":
        params = jax_lora.add_lora(params, jax.random.PRNGKey(seed + 1), rank=4)
    if trained_b:
        keys = iter(jax.random.split(jax.random.PRNGKey(seed + 2), 64))
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: 0.02 * jax.random.normal(next(keys), x.shape, x.dtype)
            if str(getattr(path[-1], "key", "")) == "lora_b" else x, params)
    return params


def write_trees(tmp, trees):
    """{key: path of the pickled numpy tree} for the ranks."""
    paths = {}
    for key, params in trees.items():
        paths[key] = str(tmp / f"{key}.pkl")
        with open(paths[key], "wb") as f:
            pickle.dump(to_numpy_tree(params), f)
    return paths


def jax_batch(spec, t_bucket=T_BUCKET):
    objective, seed, form, kw = spec
    cfg = jax_cfg(objective)
    if objective == "vlm":
        samples = [jax_sft.VLMSample(*x) for x in vlm_samples(seed, **kw)]
        return jax_sft.collate_vlm(samples, t_bucket=2, cfg=cfg, dtype=jnp.float32, **VLM_PAD)
    samples = [JaxSample(fr, ids, lab, "v") for fr, ids, lab
               in grounding_samples(train_cfg(), seed, form, **kw)]
    return jax_collate(samples, t_bucket=t_bucket, cfg=cfg, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _grad_fn(objective, hw):
    cfg = jax_cfg(objective)
    if objective == "vlm":
        def loss(p, b):
            return jax_vlm_loss(p, b, cfg, hw=1, use_flash=False, remat=True,
                                freeze_vision=True)[0]
    else:
        def loss(p, b):
            return jax_grounding_loss(p, b, cfg, hw=hw, use_flash=False, remat=True,
                                      freeze_vision=True)[0]
    return jax.jit(jax.grad(loss, allow_int=True))


def no_mesh_grads(objective, params, batch, hw=HW):
    """The JAX gradients of the whole batch with no mesh, numpy, integer
    (float0) leaves as zeros of the leaf's dtype."""
    grads = _grad_fn(objective, hw)(params, batch)
    return jax.tree.map(lambda g, p: np.zeros(p.shape, p.dtype)
                        if g.dtype == jax.dtypes.float0 else np.asarray(g), grads, params)


_STEPS = {}


def _jax_step(layout, params):
    """(mesh, sharded params, optimizer, jitted step) of a layout; layouts
    that differ only in their batch's values share one (and its compile)."""
    objective, kw = layout["batch"][0], layout["mesh"]
    use_flash, hw = layout.get("use_flash", False), layout.get("hw", HW)
    key = (tuple(sorted(kw.items())), id(params), layout["opt"], objective, use_flash, hw)
    if key not in _STEPS:
        cfg = jax_cfg(objective)
        mesh = jax_make_mesh(devices=jax.devices()[:math.prod(kw.values())], **kw)
        specs = adapt_specs_to_params(grounding_param_specs(pp=kw.get("pp", 1) > 1), params)
        sharded = shard_params(params, specs, mesh)
        make_opt = (jax_lora.make_lora_optimizer if layout["opt"] == "lora"
                    else jax_optimizer.make_grounding_optimizer)
        tx = make_opt(sharded, **TRAIN_OPT)
        if objective == "vlm":
            step = jax_sft.make_vlm_train_step(cfg, tx, hw=1, use_flash=use_flash, remat=True)
        else:
            step = jax_train_step.make_train_step(cfg, tx, hw=hw, use_flash=use_flash,
                                                  remat=True)
        # params stays referenced with its entry, so no other tree takes its id
        _STEPS[key] = (params, (mesh, sharded, tx, step))
    return _STEPS[key][1]


def jax_reference(layout, params, steps=2):
    """(metrics per step, the whole-batch no-mesh gradients before each
    step, the params after the steps, the params before them), the JAX
    package's `run_step` on its mesh for the layout."""
    objective = layout["batch"][0]
    mesh, sharded, tx, step = _jax_step(layout, params)
    state = jax_train_step.create_train_state(sharded, tx)
    # the step returns its scalars (step, Adam's counts) on the mesh: put them
    # there first, so the second step reuses the first one's compile
    replicated = NamedSharding(mesh, PartitionSpec())
    state = jax.tree.map(lambda x: jax.device_put(x, replicated) if x.ndim == 0 else x, state)
    batch = jax_batch(layout["batch"], layout.get("t_bucket", T_BUCKET))
    whole = jax.tree.map(jnp.asarray, batch)
    batch = jax.tree.map(lambda a: jax.device_put(a, batch_sharding(mesh)), batch)
    metrics, grads, before = [], [], None
    for _ in range(steps):
        now = jax.tree.map(np.asarray, state.params)
        if before is not None and all(np.array_equal(a, b) for a, b in
                                      zip(jax.tree.leaves(now), jax.tree.leaves(before))):
            grads.append(grads[-1])  # an update at learning rate 0 moved nothing
        else:
            grads.append(no_mesh_grads(objective, now, whole, layout.get("hw", HW)))
        before = now
        state, m = jax_train_step.run_step(step, state, batch, mesh=mesh,
                                           microbatches=layout.get("microbatches"))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads, jax.tree.map(np.asarray, state.params), params


def port_local(tree, objective, shape, coords, model=None):
    """{name: tensor} of the port rank at `coords` holding `tree` (params or
    gradients in the JAX layout; `model`, the port model of it, when already
    built) sliced as `shard_model` slices it."""
    if model is None:
        model = params_from_numpy(tree, train_cfg(objective))
    specs = sharding.grounding_param_specs(pp=shape.get("pp", 1) > 1)
    return sharding.shard_model(model, specs, shape, coords).state_dict()


def trainable_norm(tree, layout):
    """The norm of the gradients `tree` over the leaves that train (the
    port's `grad_norm`; the JAX metric runs over every leaf)."""
    objective = layout["batch"][0]
    model = params_from_numpy(tree, train_cfg(objective))
    make_opt = (lora.make_lora_optimizer if layout["opt"] == "lora"
                else optimizer.make_grounding_optimizer)
    names = make_opt(model, **TRAIN_OPT).trainable_names()
    flat = by_port_name(tree)
    return math.sqrt(sum(float(np.sum(np.square(flat[n].astype(np.float64)))) for n in names))


def run_layouts(tmp, world, trees, layouts, extra=()):
    """The port's world on every layout, and the JAX reference of each:
    ({layout name: [result of each rank in it]}, {name: reference}). `extra`
    ((job, kwargs), ...) run in the same world after the layouts; their
    results are under got["extra"][job], one per rank."""
    paths = write_trees(tmp, trees)
    jobs = [("train", dict(tree_paths=paths, layouts=layouts))] + list(extra)
    outs = run_world(world, "many", tmp / "world", jobs=jobs)
    want = {lay["name"]: jax_reference(lay, trees[lay["tree"]]) for lay in layouts}
    got = {lay["name"]: [o["train"][lay["name"]] for o in outs if lay["name"] in o["train"]]
           for lay in layouts}
    got["extra"] = {name: [o[name] for o in outs] for name, _ in extra}
    return got, want


def check_layout(layout, ranks, reference, ranks_expected):
    """Every rank of the layout against the JAX reference: loss (rtol 1e-5),
    pos_weight, grad_norm (the norm of the JAX gradients over the leaves
    that train), the first step's gradients and the trainable leaves after
    the steps (atol 2e-5) as this rank's slices; nothing frozen moved."""
    metrics, grads, final, _ = reference
    objective = layout["batch"][0]
    assert len(ranks) == ranks_expected
    # the same for every rank, so computed once (and once for gradients a step reused)
    norms = {}
    for g in grads:
        if id(g) not in norms:
            norms[id(g)] = trainable_norm(g, layout)
    whole_grads, whole_final = (params_from_numpy(t, train_cfg(objective))
                                for t in (grads[0], final))
    for r in ranks:
        for i, (got, want) in enumerate(zip(r["metrics"], metrics)):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                                       err_msg=f"step {i}")
            if "pos_weight" in want:
                np.testing.assert_allclose(got["pos_weight"], want["pos_weight"], rtol=1e-6)
            np.testing.assert_allclose(got["grad_norm"], norms[id(grads[i])], rtol=1e-4,
                                       err_msg=f"step {i}")
        want_grads = port_local(grads[0], objective, r["shape"], r["coords"], whole_grads)
        want_leaves = port_local(final, objective, r["shape"], r["coords"], whole_final)
        assert r["leaves"] and set(r["leaves"]) == set(r["grads"])
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g, want_grads[name].numpy(), atol=LEAF_ATOL, rtol=1e-4,
                                       err_msg=f"grad {name} at {r['coords']}")
        for name, leaf in r["leaves"].items():
            np.testing.assert_allclose(leaf, want_leaves[name].numpy(), atol=LEAF_ATOL,
                                       err_msg=f"{name} at {r['coords']}")
        assert r["frozen"] == []
    start = port_local(to_numpy_tree(reference[3]), objective, ranks[0]["shape"],
                       ranks[0]["coords"])
    assert any(not np.array_equal(leaf, start[n].numpy())
               for n, leaf in ranks[0]["leaves"].items()), "no trainable leaf moved"
