"""Training steps of the port on dp and tp meshes of gloo ranks against the
JAX package's `run_step` on the same layout of its 8-device virtual mesh
(tests/_torch_train_mesh.py): preset("tiny") with 4 LM layers, fp32, weights
from `init_grounding` bridged, tower features, `use_flash=False`, two steps
(the first has learning rate 0, the second moves the leaves). Every rank's
loss (rtol 1e-5), pos_weight, grad_norm, first-step gradients and trainable
leaves after the steps (atol 2e-5) as its own slices. Layouts: dp2 and
tp2 (full finetune), and a dp2 batch whose positives all sit on rank 0's
share (the statistics must be the whole batch's). One world of 2 ranks,
spawned once.
"""

import pytest

from _torch_train_mesh import check_layout, jax_tree, run_layouts

FEATURES = ("grounding", 1, "features", {})
LAYOUTS = [
    dict(name="dp2", mesh=dict(dp=2, tp=1), ranks=[0, 1], tree="full", opt="full",
         batch=FEATURES),
    dict(name="tp2", mesh=dict(dp=1, tp=2), ranks=[0, 1], tree="full", opt="full",
         batch=FEATURES),
    dict(name="dp2-positives-on-one-rank", mesh=dict(dp=2, tp=1), ranks=[0, 1], tree="full",
         opt="full", batch=("grounding", 2, "features", {"positive_rows": (0, 1)})),
]
RANKS = {"dp2": 2, "tp2": 2, "dp2-positives-on-one-rank": 2}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_layouts(tmp_path_factory.mktemp("train_dp_tp"), 2, {"full": jax_tree()},
                       LAYOUTS)


@pytest.mark.parametrize("layout", LAYOUTS, ids=[lay["name"] for lay in LAYOUTS])
def test_step_matches_jax_on_the_same_mesh(results, layout):
    got, want = results
    check_layout(layout, got[layout["name"]], want[layout["name"]], RANKS[layout["name"]])


def test_positives_on_one_rank_weigh_the_whole_batch(results):
    """Rank 1's share holds no positive: its own statistics would give
    pos_weight sqrt(neg) capped at 5, not the whole batch's."""
    got, want = results
    ranks = got["dp2-positives-on-one-rank"]
    assert want["dp2-positives-on-one-rank"][0][0]["pos_weight"] < 5.0
    assert ranks[0]["metrics"][0]["pos_weight"] == ranks[1]["metrics"][0]["pos_weight"]
