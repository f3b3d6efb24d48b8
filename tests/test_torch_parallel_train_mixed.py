"""Training steps of the port on meshes that mix axes, over gloo ranks,
against the JAX package's `run_step` on the same layout of its virtual mesh,
held as in tests/test_torch_parallel_train_dp_tp.py
(tests/_torch_train_mesh.py): dp2 x tp2 with LoRA r4 (replicated adapters
used on a slice: their gradients are summed over tp), and pp2 x dp2 x tp2 as
a full finetune on frames (tests/test_pipeline.py's layout and geometry; the
frozen tower runs its tp slices in the step). One world of 8 ranks, spawned
once.
"""

import pytest

from _torch_train_mesh import check_layout, jax_tree, run_layouts

FEATURES = ("grounding", 1, "features", {})
LAYOUTS = [
    dict(name="dp2-tp2-lora", mesh=dict(dp=2, tp=2), ranks=[0, 1, 2, 3], tree="lora",
         opt="lora", batch=FEATURES),
    # tests/test_pipeline.py's geometry (2 frames, hw 1): at 4 frames and hw 2 the JAX
    # step on the virtual CPU mesh can deadlock in XLA's collective rendezvous when the
    # host's cores are busy
    dict(name="pp2-dp2-tp2", mesh=dict(pp=2, dp=2, tp=2), ranks=None, tree="full",
         opt="full", batch=("grounding", 3, "frames", {"t_reals": (2, 2, 2, 2)}), hw=1,
         t_bucket=2),
]
RANKS = {"dp2-tp2-lora": 4, "pp2-dp2-tp2": 8}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    trees = {"full": jax_tree(), "lora": jax_tree(opt="lora")}
    return run_layouts(tmp_path_factory.mktemp("train_mixed"), 8, trees, LAYOUTS)


@pytest.mark.parametrize("layout", LAYOUTS, ids=[lay["name"] for lay in LAYOUTS])
def test_step_matches_jax_on_the_same_mesh(results, layout):
    got, want = results
    check_layout(layout, got[layout["name"]], want[layout["name"]], RANKS[layout["name"]])
