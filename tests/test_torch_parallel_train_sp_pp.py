"""Training steps of the port on sp and pp meshes of gloo ranks against the
JAX package's `run_step` on the same layout of its virtual mesh, held as in
tests/test_torch_parallel_train_dp_tp.py (tests/_torch_train_mesh.py): sp2
with `use_flash="train"` (the port's ring through kernels C, D and E's plain
versions, JAX's ring through its Pallas kernels in interpret mode) and pp2
(GPipe under autograd). The decoder pipeline alone
under autograd: hidden states, the input's gradient and every stage's
leaves' gradients against `jax.grad` of the JAX stack, at pp2 with 1 and 2
microbatches and at pp2 x dp2. One world of 4 ranks, spawned once.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_bridge import by_port_name
from _torch_dist import pipeline_inputs
from _torch_train_mesh import check_layout, jax_cfg, jax_tree, run_layouts
from videoitg_tpu.models.qwen2 import qwen2_hidden_states

FEATURES = ("grounding", 1, "features", {})
LAYOUTS = [
    dict(name="sp2", mesh=dict(dp=1, tp=1, sp=2), ranks=[0, 1], tree="full", opt="full",
         batch=FEATURES, use_flash="train"),
    dict(name="pp2", mesh=dict(dp=1, tp=1, pp=2), ranks=[0, 1], tree="full", opt="full",
         batch=FEATURES),
]
RANKS = {"sp2": 2, "pp2": 2}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_sp_pp")
    trees = {"full": jax_tree()}
    from _torch_train_mesh import write_trees

    paths = write_trees(tmp, {"stack": trees["full"]})
    return run_layouts(tmp, 4, trees, LAYOUTS,
                       extra=[("pipeline_grad", dict(tree_path=paths["stack"]))])


@pytest.mark.parametrize("layout", LAYOUTS, ids=[lay["name"] for lay in LAYOUTS])
def test_step_matches_jax_on_the_same_mesh(results, layout):
    got, want = results
    check_layout(layout, got[layout["name"]], want[layout["name"]], RANKS[layout["name"]])


@functools.lru_cache(maxsize=None)
def _jax_stack_grads():
    """The JAX decoder stack's hidden states, and the gradients of its
    leaves and of its input under a seeded linear loss."""
    params = jax_tree()
    x, pos, valid = pipeline_inputs(0)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    cfg = jax_cfg().lm

    def loss(lm, x_):
        h = qwen2_hidden_states(lm, x_, jnp.asarray(pos), jnp.asarray(valid), cfg)
        return jnp.sum(h * r), h

    (_, h), (g_lm, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params["lm"], jnp.asarray(x))
    return (np.asarray(h), np.asarray(g_x),
            by_port_name({"lm": jax.tree.map(np.asarray, g_lm)}))


@pytest.mark.parametrize("key,ranks", [("pp2-m1", 2), ("pp2-m2", 2), ("pp2-dp2-mNone", 4)])
def test_pipeline_gradients_match_jax(results, key, ranks):
    """Every stage holds the whole input gradient (broadcast from stage 0) and
    its own layers' gradients; the hidden states are the same on every stage."""
    got, _ = results
    h, g_x, want = _jax_stack_grads()
    outs = [o[key] for o in got["extra"]["pipeline_grad"][:ranks]]
    for out in outs:
        np.testing.assert_allclose(out["h"], h, atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(out["dx"], g_x, atol=2e-5, rtol=1e-5)
    if key.startswith("pp2-dp2"):
        return  # each dp rank's leaf gradients are of its share of the batch
    seen = set()
    for out in outs:
        assert out["grads"]
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g, want[name], atol=2e-5, rtol=1e-5, err_msg=name)
            seen.add(name)
    assert seen == {n for n in want if n.startswith("lm.layers.")}
