"""The port's eval package (`videoitg_tpu_torch/eval/`) and its helpers are
copies of the JAX package's: each file is its original with `videoitg_tpu.`
replaced by `videoitg_tpu_torch.`, apart from the differences named below,
and the registries, the argument parser and the harness's helpers give the
same results. Every comparison here is for equality.

Differences, each held by its own test:
- `eval/harness.py`: `run_metadata` writes `torch_version` and the device
  type where the JAX package writes `jax_version` and jax's backend.
- `eval/multihost.py`: the barrier and the gather over torch.distributed,
  where the JAX package's ride the JAX distributed runtime.
- `eval/adapters/videoitg.py`: the grounding adapter on the port's engine.
- `eval/adapters/downstream.py`: the two adapters that hold a torch model
  (`InternVLChatAdapter`, `QwenVLChatAdapter`) take `device=` and move their
  model and inputs there.
- `eval/adapters/native_vlm.py`: the native VLM adapter on the port's
  models/vlm.py, with `device=`.
- A few docstrings and one message say "offline" where the originals spoke
  of the machine they were written on (`REWORDED`).
"""

import ast
import dataclasses
import functools
import inspect
import os
import pathlib

import pytest

from videoitg_tpu.eval import api as jax_api
from videoitg_tpu.eval import harness as jax_harness
from videoitg_tpu.utils import common as jax_common
from videoitg_tpu_torch.eval import api, harness, multihost
from videoitg_tpu_torch.utils import common

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_EVAL = REPO / "videoitg_tpu" / "eval"
PORT_EVAL = REPO / "videoitg_tpu_torch" / "eval"
DIFFERENT = {"harness.py", "multihost.py", "adapters/videoitg.py", "adapters/downstream.py",
             "adapters/native_vlm.py"}
# file -> {line number: the copy's line}: the only lines where a copy's text
# differs from its renamed original.
REWORDED = {
    "tasks/detailcaps.py": {
        15: "both dependency-bound offline and both also gated/absent",
        72: '    the upstream package exists (it is not installed offline)."""',
    },
    "tasks/mmsearch.py": {
        21: "  pluggable ``SearchBackend`` — no egress offline, so the",
        286: '            "run has no egress. mmsearch_rerank and "',
    },
    "tracker.py": {14: "dataset repo (the default backend offline); any other value goes"},
}
ORIGINALS = sorted(str(p.relative_to(JAX_EVAL)) for p in JAX_EVAL.rglob("*.py"))
COPIES = [f for f in ORIGINALS if f not in DIFFERENT]


def _renamed(text: str) -> str:
    return text.replace("videoitg_tpu.", "videoitg_tpu_torch.")


def test_the_port_holds_every_eval_module_but_the_later_adapters():
    """Every eval module of the JAX package, the adapters included."""
    port = sorted(str(p.relative_to(PORT_EVAL)) for p in PORT_EVAL.rglob("*.py"))
    assert port == ORIGINALS
    assert len(ORIGINALS) == 118 and len(COPIES) == 113


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_original_renamed(rel):
    want = _renamed((JAX_EVAL / rel).read_text()).split("\n")
    got = (PORT_EVAL / rel).read_text().split("\n")
    reworded = REWORDED.get(rel, {})
    assert len(got) == len(want)
    assert {i + 1 for i, (a, b) in enumerate(zip(got, want)) if a != b} == set(reworded)
    for line, text in reworded.items():
        assert got[line - 1] == text, (rel, line)


def _without(source: str, *names: str) -> str:
    """The module's AST with the named top-level definitions left out."""
    tree = ast.parse(source)
    keep = []
    for node in tree.body:
        targets = ([node.name] if isinstance(node, (ast.FunctionDef, ast.ClassDef))
                   else [t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)]
                   + ([node.target.id] if isinstance(node, ast.AnnAssign) else []))
        if not set(targets) & set(names):
            keep.append(node)
    tree.body = keep
    return ast.dump(tree)


@pytest.mark.parametrize("rel,names", [
    ("adapters/downstream.py", ("InternVLChatAdapter", "QwenVLChatAdapter")),
    ("harness.py", ("run_metadata",)),
], ids=["downstream", "harness"])
def test_differing_copies_differ_only_where_named(rel, names):
    got = (PORT_EVAL / rel).read_text()
    want = _renamed((JAX_EVAL / rel).read_text())
    assert _without(got, *names) == _without(want, *names)


def test_run_metadata_writes_torch_keys():
    meta = harness.run_metadata(model="videoitg", model_args="a=1", world_size=2,
                                limit=5, seed=7)
    want = jax_harness.run_metadata(model="videoitg", model_args="a=1", world_size=2,
                                    limit=5, seed=7)
    import torch

    assert set(want) - set(meta) == {"jax_version"}
    assert set(meta) - set(want) == {"torch_version"}
    assert meta["torch_version"] == torch.__version__
    assert meta["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert harness.run_metadata(backend="cpu")["backend"] == "cpu"
    for key in ("model", "model_args", "world_size", "limit", "seed", "git_hash"):
        assert meta[key] == want[key], key


def test_adapter_copy_keeps_the_generate_until_and_every_argument():
    from videoitg_tpu.eval.adapters.videoitg import VideoITGAdapter as JaxAdapter
    from videoitg_tpu_torch.eval.adapters.videoitg import VideoITGAdapter

    def body(cls):
        src = inspect.getsource(cls.generate_until).replace("videoitg_tpu_torch", "videoitg_tpu")
        return ast.dump(ast.parse(inspect.cleandoc("\n" + src)))

    assert body(VideoITGAdapter) == body(JaxAdapter)
    want = inspect.signature(JaxAdapter.__init__).parameters
    got = inspect.signature(VideoITGAdapter.__init__).parameters
    assert list(got) == [*[p for p in want if p != "_ignored"], "device", "_ignored"]
    for name, p in want.items():
        assert got[name].default == p.default and got[name].kind == p.kind, name
    assert VideoITGAdapter.model_name == JaxAdapter.model_name == "videoitg"


# The adapter names of ROADMAP queue 1, items 5b and 5c, refused by name
# until the port had them.
LATER_ADAPTERS = {**dict.fromkeys(("echo-answer", "internvl-chat", "qwen-vl-chat",
                                   "llava-ov-chat", "hf-video-llm", "api-chat"), "5b"),
                  "videoitg-vlm": "5c"}


@pytest.mark.parametrize("name,item", sorted(LATER_ADAPTERS.items()))
def test_not_ported_adapter_names_are_refused_with_their_item(name, item):
    """None of them is refused now: each resolves to the port's counterpart
    of the JAX package's class (or dispatch function), by module and name."""
    want, got = jax_api.get_adapter(name), api.get_adapter(name)
    assert got.__qualname__ == want.__qualname__
    assert got.__module__ == want.__module__.replace("videoitg_tpu.", "videoitg_tpu_torch.")
    assert got.__module__.startswith("videoitg_tpu_torch.eval.adapters.")


def test_adapter_registry_and_unknown_names():
    assert api.get_adapter("videoitg").__module__ == "videoitg_tpu_torch.eval.adapters.videoitg"
    assert sorted(api.ADAPTER_REGISTRY) == sorted(jax_api.ADAPTER_REGISTRY)
    assert set(api.ADAPTER_REGISTRY) == set(LATER_ADAPTERS) | {"videoitg"}
    with pytest.raises(KeyError, match="unknown model adapter"):
        api.get_adapter("no-such-adapter")


@pytest.mark.parametrize("name", ["internvl-chat", "qwen-vl-chat", "videoitg-vlm"])
def test_model_adapters_keep_every_argument_and_add_device(name):
    want = inspect.signature(jax_api.get_adapter(name).__init__).parameters
    got = inspect.signature(api.get_adapter(name).__init__).parameters
    extra = [p for p in want if p in ("kwargs", "_ignored")]
    assert list(got) == [*[p for p in want if p not in extra], "device", *extra]
    for p, param in want.items():
        assert got[p].default == param.default and got[p].kind == param.kind, p
    assert got["device"].default is None


def _norm(x):
    """A registry value with its callables named by module and qualname, so
    the two packages' registries compare field by field."""
    if isinstance(x, functools.partial):
        return ("partial", _norm(x.func), _norm(list(x.args)), _norm(x.keywords))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__qualname__,
                {f.name: _norm(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if callable(x) and hasattr(x, "__qualname__"):
        return ("callable", getattr(x, "__module__", "").replace("videoitg_tpu_torch", "videoitg_tpu"),
                x.__qualname__)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    assert not callable(x), x
    return x


def test_task_and_group_registries_equal_field_by_field():
    api.get_task("videomme")
    jax_api.get_task("videomme")
    assert list(api.TASK_REGISTRY) == list(jax_api.TASK_REGISTRY)
    assert len(api.TASK_REGISTRY) > 100
    for name, task in api.TASK_REGISTRY.items():
        want = jax_api.TASK_REGISTRY[name]
        assert type(task).__module__ == "videoitg_tpu_torch.eval.api"
        assert _norm(task) == _norm(want), name
    assert api.GROUP_REGISTRY == jax_api.GROUP_REGISTRY and api.GROUP_REGISTRY


@pytest.mark.parametrize("text", [
    "", "pretrained=/x,num_frames=512,target_fps=1.5,flag=True",
    "a=1,,b=FALSE,c=1e-3,d=x=y,e=", "random_init=True,preset=tiny,dtype=float32"])
def test_parse_model_args_equal(text):
    assert api.parse_model_args(text) == jax_api.parse_model_args(text)


@pytest.mark.parametrize("n,world", [(0, 1), (10, 3), (7, 2), (5, 8)])
def test_shard_items_equal(n, world):
    items = list(range(n))
    for rank in range(world):
        assert api.shard_items(items, rank, world) == jax_api.shard_items(items, rank, world)


def test_expand_task_names_and_integrity_equal():
    names = [[g] for g in sorted(jax_api.GROUP_REGISTRY)] + [
        ["videomme", "mvbench"], ["videomme", "videomme"], ["no_such_task"]]
    for group in names:
        assert api.expand_task_names(group) == jax_api.expand_task_names(group)
        assert api.check_registry_integrity(group) == jax_api.check_registry_integrity(group)
    assert api.check_registry_integrity() == jax_api.check_registry_integrity()


def test_utils_helpers_are_the_originals():
    for name in ("call_with_data_root", "violates_moderation"):
        got = ast.parse(inspect.getsource(getattr(common, name)))
        want = ast.parse(inspect.getsource(getattr(jax_common, name)))
        for tree in (got, want):
            tree.body[0].body = tree.body[0].body[1:]  # the docstring
        assert ast.dump(got) == ast.dump(want), name

    def visual(doc, data_root=""):
        return os.path.join(data_root, doc["v"])

    for fn in (visual, lambda doc: doc["v"]):
        assert common.call_with_data_root(fn, {"v": "a.mp4"}, "/r") == \
            jax_common.call_with_data_root(fn, {"v": "a.mp4"}, "/r")
    os.environ.pop("MODERATION_ENDPOINT", None)
    assert common.violates_moderation("hello") is jax_common.violates_moderation("hello") is False


def test_resolve_dtype_maps_the_same_names():
    import jax.numpy as jnp
    import torch

    for name in ("bfloat16", "float32", "float16"):
        assert str(common.resolve_dtype(name)).split(".")[-1] == jnp.dtype(
            jax_common.resolve_dtype(name)).name
    assert common.resolve_dtype(None) == torch.bfloat16
    assert common.resolve_dtype(None, "cuda") == torch.bfloat16
    # the JAX rule on its CPU backend, with the device in place of the backend
    assert common.resolve_dtype(None, "cpu") == torch.float32 == \
        getattr(torch, jnp.dtype(jax_common.resolve_dtype(None)).name)
    with pytest.raises(KeyError):
        common.resolve_dtype("int3")


def test_multihost_is_one_process():
    assert not multihost.is_multiprocess()
    assert multihost.barrier("x") is None
    assert multihost.gather_objects({"a": 1}) == [{"a": 1}]
    from videoitg_tpu.eval import multihost as jax_multihost

    def functions(mod):
        return sorted(n for n, f in vars(mod).items()
                      if inspect.isfunction(f) and f.__module__ == mod.__name__)

    assert functions(multihost) == functions(jax_multihost) == [
        "barrier", "gather_objects", "is_multiprocess"]


def test_multihost_gathers_across_two_gloo_ranks(tmp_path):
    """In a torch.distributed group of 2 gloo ranks the barrier holds and
    every rank receives every rank's object, in rank order."""
    from _torch_dist import run_world

    outs = run_world(2, "multihost", tmp_path)
    want = [{"rank": 0, "text": ""}, {"rank": 1, "text": "é"}]
    assert outs == [{"multiprocess": True, "gathered": want}] * 2
