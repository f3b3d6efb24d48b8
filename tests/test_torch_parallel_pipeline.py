"""The port's decoder pipeline (videoitg_tpu_torch/parallel/pipeline.py) over
gloo ranks against the JAX package's `qwen2_hidden_states` (atol 2e-5, rtol
1e-5) on bridged tiny weights: pp=2 alone with 1, 2 and 4 microbatches, and
pp=2 x dp=2 with the batch split over dp. One world of 4 ranks, spawned
once, runs every case; every stage returns the same hidden states.
"""

import pickle

import numpy as np
import pytest

import jax.numpy as jnp

from _torch_bridge import tiny_params, to_numpy_tree
from _torch_dist import pipeline_inputs, run_world
from videoitg_tpu.config import preset
from videoitg_tpu.models.qwen2 import qwen2_hidden_states
from videoitg_tpu_torch.parallel.pipeline import default_microbatches

TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    params = tiny_params(seed=9)
    with open(tmp / "tree.pkl", "wb") as f:
        pickle.dump(to_numpy_tree(params), f)
    outs = run_world(4, "pipeline", tmp / "world", tree_path=str(tmp / "tree.pkl"))
    x, pos, valid = pipeline_inputs(0)
    want = np.asarray(qwen2_hidden_states(params["lm"], jnp.asarray(x), jnp.asarray(pos),
                                          jnp.asarray(valid), preset("tiny").lm))
    return outs, want


@pytest.mark.parametrize("key,ranks", [("pp2-m1", 2), ("pp2-m2", 2), ("pp2-m4", 2),
                                       ("pp2-dp2-mNone", 4)])
def test_pipeline_matches_jax_hidden_states(case, key, ranks):
    outs, want = case
    for out in outs[:ranks]:
        np.testing.assert_allclose(out[key], want, **TOL)


def test_schedule_defaults():
    assert [default_microbatches(b, 4) for b in (1, 2, 3, 4, 6, 8)] == [1, 2, 3, 4, 3, 4]
