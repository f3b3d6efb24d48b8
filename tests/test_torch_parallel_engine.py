"""The port's SelectionEngine on a device mesh (gloo ranks) against the JAX
engine on the same bridged tiny weights, fp32: in each layout (dp=2, tp=2,
sp=2, pp=2, dp=2 x tp=2) `select`, `select_many` (3 questions: dp pads the
last group) and `score_frames` (3 videos: dp pads the batch) give the JAX
engine's Top-K with scores within atol 2e-5 (tests/test_engine.py), the same
on every rank. Also the quantised tiers at tp=2, on the JAX-quantised trees:

* act8 (the row-parallel linears quantise with the whole row's amax, an
  all-reduce MAX over tp): each row-parallel linear of the tower and the LM
  on rows whose amax lies in one rank's half equals JAX's act8 linear on the
  whole row (atol = rtol = 1e-6, TIGHT of tests/test_torch_quant.py; a
  rank's local amax misses by far more); the engine's Top-K equals the JAX
  engine's on a tp=2 mesh (GSPMD) with scores within the tier's 1e-2
  (tests/test_torch_quant.py: the fp32 summation order flips int8 roundings
  of activations on a boundary; on these inputs the JAX engine's own tp=2
  and unsharded scores differ by up to 5.4e-3); and tp=2 against tp=1 at
  2e-5 (the same summation order here, so no flip);
* int4 (a row-parallel rank holds its own input rows, repacked): Top-K equal
  to the JAX engine's on a tp=2 mesh, scores within 2e-5.

And tp=4's ValueError, with the JAX engine's message. One world of 4 ranks,
spawned once, runs every case.
"""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_bridge import tiny_params, to_numpy_tree
from _torch_dist import (ENGINE_LAYOUTS, QUESTIONS, ROW_LINEARS, frames, row_linear_input,
                         run_world)
from videoitg_tpu.config import preset
from videoitg_tpu.engine import SelectionEngine as JaxEngine
from videoitg_tpu.models.common import linear as jax_linear
from videoitg_tpu.ops.quant import apply_quantization_tier
from videoitg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from videoitg_tpu.utils.common import CharTokenizer

ATOL = 2e-5
TIERS = ("act8", "int4")
TIER_ATOL = {"act8": 1e-2, "int4": ATOL}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    params = tiny_params(seed=0)
    trees = {"dense": params, **{t: apply_quantization_tier(params, t) for t in TIERS}}
    paths = {}
    for name, tree in trees.items():
        paths[name] = str(tmp / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(to_numpy_tree(tree), f)
    outs = run_world(4, "engine", tmp / "world", tree_path=paths.pop("dense"),
                     tier_paths=paths)
    cfg = preset("tiny")
    tok = CharTokenizer(cfg.lm.vocab_size)

    def calls(tree, mesh=None):
        engine = JaxEngine(tree, cfg, tok, dtype=jnp.float32, use_flash=False,
                           buckets=(4, 8), num_frames=8, mesh=mesh)
        sel = engine.select(frames(0, 6), list(range(0, 60, 10)), QUESTIONS[0])
        many = engine.select_many(frames(1, 5), list(range(5)), QUESTIONS)
        batch = engine.score_frames([frames(2, 4), frames(3, 4), frames(4, 3)], QUESTIONS)
        return {"select": (sel.index, sel.raw_scores),
                "select_many": [(r.index, r.raw_scores) for r in many],
                "score_frames": batch}

    want = calls(params)
    tp2 = jax_make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    want_tiers = {t: calls(trees[t], tp2) for t in TIERS}
    for name in ROW_LINEARS:
        tower, _, i, key = name.split(".")
        lin = {k: None if v is None else v[int(i)]
               for k, v in trees["act8"][tower]["layers"][key].items()}
        x = row_linear_input(lin["w_q"].shape[0])
        want_tiers[f"row-{name}"] = np.asarray(jax_linear(lin, jnp.asarray(x)))
    try:
        JaxEngine(params, cfg, tok, dtype=jnp.float32,
                  mesh=jax_make_mesh(dp=1, tp=4, devices=jax.devices()[:4]))
    except ValueError as e:
        jax_error = str(e)
    return outs, want, jax_error, want_tiers


def _same(got, want, atol=ATOL):
    (gi, gs), (wi, ws) = got, want
    assert gi == wi
    np.testing.assert_allclose(gs, ws, atol=atol, rtol=0)


def _check(calls, want, atol=ATOL):
    _same(calls["select"], want["select"], atol)
    assert len(calls["select_many"]) == len(want["select_many"])
    for g, w in zip(calls["select_many"], want["select_many"]):
        _same(g, w, atol)
    assert len(calls["score_frames"]) == 3
    for g, w in zip(calls["score_frames"], want["score_frames"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("layout", sorted(ENGINE_LAYOUTS))
def test_engine_on_a_mesh_matches_the_jax_engine(world, layout):
    outs, want, _, _ = world
    ranks = 4 if ENGINE_LAYOUTS[layout][1] is None else 2
    for out in outs[:ranks]:
        _check(out[layout], want)
    # the sp layout rings every LM layer, the pp layout pipelines every LM
    # pass: 5 LM passes (select 1, select_many 3 over one video, score_frames 1)
    n_lm = 5
    assert outs[0][layout]["calls"] == {
        "sp2": {"ring_attention": n_lm * 2}, "pp2": {"pipeline_hidden_states": n_lm}
    }.get(layout, {})
    first = outs[0][layout]
    for out in outs[1:ranks]:  # every rank returns the same result
        np.testing.assert_array_equal(out[layout]["select"][1], first["select"][1])


@pytest.mark.parametrize("tier", TIERS)
def test_quantized_tiers_at_tp2_match_the_jax_engine(world, tier):
    outs, _, _, want_tiers = world
    for out in outs[:2]:
        _check(out[f"{tier}-tp2"], want_tiers[tier], TIER_ATOL[tier])


@pytest.mark.parametrize("name", ROW_LINEARS)
def test_act8_row_parallel_linear_matches_jax_on_the_whole_row(world, name):
    outs, _, _, want_tiers = world
    for out in outs[:2]:
        np.testing.assert_allclose(out[f"row-{name}"], want_tiers[f"row-{name}"],
                                   rtol=1e-6, atol=1e-6)


def test_act8_at_tp2_matches_tp1(world):
    outs, _, _, _ = world
    for out in outs[:2]:
        one = out["act8-tp1"]
        _check(out["act8-tp2"], {"select": one["select"], "select_many": one["select_many"],
                                 "score_frames": one["score_frames"]})


def test_tp_that_does_not_divide_the_heads_is_a_value_error(world):
    outs, _, jax_error, _ = world
    assert "tp=4 does not divide LM kv head count 2" in jax_error
    assert [out["tp4-error"] for out in outs] == [jax_error] * 4
