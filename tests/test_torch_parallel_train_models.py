"""Training steps of the port's other model forms on a pipeline mesh of
gloo ranks against the JAX package's `run_step` on the same layout of its
virtual mesh (tests/test_pipeline.py's QLoRA and VLM-SFT cases, held as in
tests/_torch_train_mesh.py): QLoRA (an int8 base, frozen and bit-identical,
with LoRA r4 adapters) and the causal VLM-SFT objective (tied embeddings:
the embedding is used before and after the pipeline), both on pp2 x dp2.
One world of 4 ranks, spawned once.
"""

import pytest

from _torch_train_mesh import check_layout, jax_tree, run_layouts

LAYOUTS = [
    dict(name="qlora-pp2-dp2", mesh=dict(pp=2, dp=2, tp=1), ranks=None, tree="qlora",
         opt="lora", batch=("grounding", 4, "features", {})),
    dict(name="vlm-pp2-dp2", mesh=dict(pp=2, dp=2, tp=1), ranks=None, tree="vlm", opt="full",
         batch=("vlm", 5, None, {})),
]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    trees = {"qlora": jax_tree(opt="lora", quant="int8"), "vlm": jax_tree("vlm")}
    return run_layouts(tmp_path_factory.mktemp("train_models"), 4, trees, LAYOUTS)


@pytest.mark.parametrize("layout", LAYOUTS, ids=[lay["name"] for lay in LAYOUTS])
def test_step_matches_jax_on_the_same_mesh(results, layout):
    got, want = results
    check_layout(layout, got[layout["name"]], want[layout["name"]], 4)
