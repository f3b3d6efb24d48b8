"""Serving checkpoints in the port (videoitg_tpu_torch/checkpoint.py
`save_serving_checkpoint` / `load_serving_checkpoint`), against the JAX
package's (videoitg_tpu/checkpoint.py, tests/test_serving_checkpoint.py).

Save and load in the port give back every leaf bit for bit, and the same raw
scores and Top-K, in every tier. The JAX layout (an orbax `params/` tree) and
the port's (`params.safetensors` under the same dotted paths) convert into
each other bit for bit, `act_q` markers included, and both writers write the
same `serving_config.json` bytes; int8 / int4 scores of the two engines on
the two directories agree at tests/test_engine.py's atol. `select
--export-serving` / `--model DIR`, the tier-mismatch error, the refusal of a
JAX-layout directory and the `videoitg` adapter run in-process; a LoRA run
restored from its training checkpoint, merged and exported scores as its
runtime adapters did, and an unmerged QLoRA model round-trips bit-equal.
`preset("tiny")`, fp32 (bf16 where named), CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_bridge import bridged_pair, make_batches, tiny_params, to_numpy_tree
from test_torch_checkpoint import assert_same_model as assert_same_leaves
from test_torch_checkpoint import write_hf_dir, write_tokenizer
from videoitg_tpu import checkpoint as jax_ckpt
from videoitg_tpu.config import preset as jax_preset
from videoitg_tpu.engine import SelectionEngine as JaxEngine
from videoitg_tpu.ops.quant import apply_quantization_tier as jax_apply_tier
from videoitg_tpu.utils.common import CharTokenizer as JaxTok
from videoitg_tpu_torch import checkpoint as ckpt
from videoitg_tpu_torch.config import preset
from videoitg_tpu_torch.engine import SelectionEngine
from videoitg_tpu_torch.models.common import has_lora
from videoitg_tpu_torch.ops.quant import QuantLinear, apply_quantization_tier
from videoitg_tpu_torch.train import checkpointing, lora, train_step
from videoitg_tpu_torch.utils.common import CharTokenizer

CFG, JCFG = preset("tiny"), jax_preset("tiny")
TIERS = [None, "int8", "int4", "act8"]
ATOL = 2e-5  # tests/test_engine.py
PROMPT = "find the frames where the rocket launches"


def _frames():
    rng = np.random.default_rng(12)
    return rng.integers(0, 256, (7, 56, 56, 3), dtype=np.uint8), [3 * i for i in range(7)]


def port_select(model):
    engine = SelectionEngine(model, CFG, CharTokenizer(CFG.lm.vocab_size), device="cpu",
                             dtype=torch.float32, buckets=(8,), num_frames=8)
    return engine.select(*_frames(), PROMPT)


def jax_select(params):
    engine = JaxEngine(params, JCFG, JaxTok(JCFG.lm.vocab_size), dtype=jnp.float32,
                       use_flash=False, buckets=(8,), num_frames=8)
    return engine.select(*_frames(), PROMPT)


def port_model(tier, seed=3, dtype=torch.float32):
    _, model = bridged_pair(tiny_params(seed=seed))
    model = model.to(dtype)
    return apply_quantization_tier(model, tier) if tier else model


def assert_same_model(got, want):
    """Every leaf bit for bit in its dtype, and every module of the same kind
    (dense or quantised, bits, act_q)."""
    assert_same_leaves(got, want)

    def kinds(model):
        return [(name, type(m).__name__, getattr(m, "act_q", None), getattr(m, "bits", None))
                for name, m in model.named_modules()]

    assert kinds(got) == kinds(want)


@pytest.mark.parametrize("tier", TIERS, ids=str)
def test_round_trip_is_bit_equal(tmp_path, tier):
    model = port_model(tier)
    out = ckpt.save_serving_checkpoint(model, CFG, str(tmp_path / "srv"), quantize=tier)
    assert out == str(tmp_path / "srv") and ckpt.is_serving_checkpoint(out)
    assert sorted(os.listdir(out)) == ["params.safetensors", "serving_config.json"]
    loaded, cfg, saved_tier = ckpt.load_serving_checkpoint(out, device="cpu")
    assert cfg == CFG and saved_tier == tier
    assert_same_model(loaded, model)
    got, want = port_select(loaded), port_select(model)
    assert np.array_equal(got.raw_scores, want.raw_scores) and got.index == want.index


def test_bf16_leaves_stay_bf16_and_stacked_leaves_stream_by_layer(tmp_path):
    model = port_model("act8", dtype=torch.bfloat16)
    entries, markers = ckpt._serving_entries(model)
    made = {name: make() for name, _, _, make in entries}
    rows = [t.shape for t in made["lm.layers.q.w_q"]]
    assert rows == [(CFG.lm.hidden_size, CFG.lm.q_dim)] * CFG.lm.num_layers
    assert "lm.layers.q.act_q" in markers and "vision.layers.fc1.act_q" in markers
    ckpt.save_serving_checkpoint(model, CFG, str(tmp_path), quantize="act8")
    refs, meta = ckpt._safetensors_index(str(tmp_path / "params.safetensors"))
    assert sorted(json.loads(meta["act_q"])) == sorted(markers)
    dtypes = {name: ref.dtype for name, ref in refs.items()}
    assert dtypes["lm.embed.w"] == dtypes["lm.layers.input_norm.scale"] == torch.bfloat16
    assert dtypes["lm.layers.q.w_q"] == torch.int8 and dtypes["lm.layers.q.scale"] == torch.float32
    assert refs["lm.layers.q.w_q"].shape == (CFG.lm.num_layers, CFG.lm.hidden_size, CFG.lm.q_dim)
    loaded, _, _ = ckpt.load_serving_checkpoint(str(tmp_path), device="cpu")
    assert_same_model(loaded, model)


def test_a_directory_without_port_weights_or_of_another_format_is_refused(tmp_path):
    ckpt.save_serving_checkpoint(port_model(None), CFG, str(tmp_path))
    os.remove(tmp_path / "params.safetensors")
    with pytest.raises(FileNotFoundError, match="no params.safetensors.*--export-serving"):
        ckpt.load_serving_checkpoint(str(tmp_path), device="cpu")
    (tmp_path / "serving_config.json").write_text(json.dumps({"format": "other", "config": {}}))
    with pytest.raises(ValueError, match="serving format 'other'"):
        ckpt.load_serving_checkpoint(str(tmp_path), device="cpu")


# ---- the JAX layout and the port's ----

_JAX_DIRS = {}


def jax_dir(tmp_path_factory, tier, dtype="float32"):
    """A serving directory written by the JAX package: the tiny model of seed
    3 in `dtype`, in `tier`; written once per module."""
    key = (tier, dtype)
    if key not in _JAX_DIRS:
        params = jax.tree.map(lambda x: x.astype(dtype), tiny_params(seed=3))
        if tier:
            params = jax_apply_tier(params, tier)
        path = str(tmp_path_factory.mktemp("jax_serving") / "srv")
        jax_ckpt.save_serving_checkpoint(params, JCFG, path, quantize=tier)
        _JAX_DIRS[key] = path
    return _JAX_DIRS[key]


def _bits(arr: np.ndarray) -> np.ndarray:
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _nest(flat: dict) -> dict:
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


CONVERSIONS = [(None, "float32"), ("int8", "float32"), ("int4", "float32"),
               ("act8", "float32"), ("int8", "bfloat16"), ("act8", "bfloat16")]


@pytest.mark.parametrize("tier,dtype", CONVERSIONS, ids=lambda v: str(v))
def test_jax_and_port_layouts_convert_bit_for_bit(tmp_path, tmp_path_factory, tier, dtype):
    jdir = jax_dir(tmp_path_factory, tier, dtype)
    params, jcfg, jtier = jax_ckpt.load_serving_checkpoint(jdir)
    want = dict(ckpt._flatten(jax.tree.map(np.asarray, params)))
    markers = sorted(path for path, value in want.items() if value is None)
    assert (tier == "act8") == bool(markers)
    # JAX -> the port's writer
    model = ckpt.params_from_numpy(to_numpy_tree(params), CFG,
                                   dtype=getattr(torch, dtype))
    pdir = ckpt.save_serving_checkpoint(model, CFG, str(tmp_path / "port"), quantize=jtier)
    with open(os.path.join(jdir, "serving_config.json"), "rb") as f, \
            open(os.path.join(pdir, "serving_config.json"), "rb") as g:
        assert f.read() == g.read()
    refs, meta = ckpt._safetensors_index(os.path.join(pdir, "params.safetensors"))
    assert sorted(json.loads(meta["act_q"])) == markers
    assert set(refs) == {path for path, value in want.items() if value is not None}
    for path, ref in refs.items():
        got = _to_numpy(ref.read())
        assert got.dtype == want[path].dtype and got.shape == want[path].shape, path
        assert np.array_equal(_bits(got), _bits(want[path])), path
    # ... and back: the port's file -> a JAX tree -> the JAX writer and reader
    back = {path: jnp.asarray(_to_numpy(ref.read())) for path, ref in refs.items()}
    back.update((marker, None) for marker in json.loads(meta["act_q"]))
    jax_ckpt.save_serving_checkpoint(_nest(back), jcfg, str(tmp_path / "back"), quantize=jtier)
    again, _, again_tier = jax_ckpt.load_serving_checkpoint(str(tmp_path / "back"))
    assert again_tier == tier
    again = dict(ckpt._flatten(jax.tree.map(np.asarray, again)))
    assert again.keys() == want.keys()
    for path, value in want.items():
        if value is None:
            assert again[path] is None, path
        else:
            assert again[path].dtype == value.dtype, path
            assert np.array_equal(_bits(again[path]), _bits(value)), path


def test_a_jax_directory_is_refused_naming_the_remedy(tmp_path_factory):
    jdir = jax_dir(tmp_path_factory, "int8")
    with pytest.raises(FileNotFoundError, match=r"orbax params/ tree.*"
                                                r"videoitg-torch-select .*--export-serving"):
        ckpt.load_serving_checkpoint(jdir, device="cpu")


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_port_scores_on_its_directory_match_the_jax_engine_on_the_jax_one(
        tmp_path, tmp_path_factory, tier):
    """act8 is held to its leaves above only: a value on an int8 rounding
    boundary may round the other way in the two frameworks (ROADMAP queue 3)."""
    jdir = jax_dir(tmp_path_factory, tier)
    params, _, _ = jax_ckpt.load_serving_checkpoint(jdir)
    model = ckpt.params_from_numpy(to_numpy_tree(params), CFG)
    pdir = ckpt.save_serving_checkpoint(model, CFG, str(tmp_path / "port"), quantize=tier)
    loaded, _, _ = ckpt.load_serving_checkpoint(pdir, device="cpu")
    got, want = port_select(loaded), jax_select(params)
    np.testing.assert_allclose(got.raw_scores, want.raw_scores, atol=ATOL, rtol=0)
    assert got.index == want.index


# ---- the entry points ----


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """An HF-format directory of the tiny model with a tokenizer, and a video."""
    from videoitg_tpu_torch.data.video import write_test_video

    root = tmp_path_factory.mktemp("serving_cli")
    params = tiny_params(seed=5)
    path = write_hf_dir(jax_ckpt.export_grounding_state_dict(params, JCFG), JCFG.to_json(),
                        root / "hf")
    write_tokenizer(path)
    try:
        video = write_test_video(str(root / "v.mp4"), 64, 48, 30, 10, 8)
    except OSError as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")
    return path, video, root


def _select(capsys, model, video, *flags):
    from videoitg_tpu_torch.cli.select import main

    rc = main(["--cpu", "--model", model, "--video", video, "--prompt", "find the rocket",
               "--topk", "3", "--num-frames", "6", "--dtype", "float32", "--json", *flags])
    captured = capsys.readouterr()
    return rc, captured


@pytest.fixture(scope="module")
def exported(hf_dir, tmp_path_factory):
    """`select --quantize act8 --export-serving DIR` on the HF directory: the
    directory and the record of that run."""
    from videoitg_tpu_torch.cli.select import main

    ckpt_dir, video, root = hf_dir
    srv = str(root / "serving")
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--cpu", "--model", ckpt_dir, "--video", video, "--prompt", "find the rocket",
                   "--topk", "3", "--num-frames", "6", "--dtype", "float32", "--json",
                   "--quantize", "act8", "--export-serving", srv])
    assert rc == 0, err.getvalue()
    assert f"[videoitg-torch-select] serving checkpoint written to {srv}" in err.getvalue()
    return srv, json.loads(out.getvalue().strip().splitlines()[-1])


def test_select_export_then_model_gives_the_same_record(hf_dir, exported, capsys):
    _, video, _ = hf_dir
    srv, record = exported
    assert {"serving_config.json", "params.safetensors", "tokenizer.json",
            "tokenizer_config.json"} <= set(os.listdir(srv))
    rc, captured = _select(capsys, srv, video)
    assert rc == 0, captured.err
    again = json.loads(captured.out.strip().splitlines()[-1])
    assert again["index"] == record["index"] and again["logits"] == record["logits"]
    assert "random weights" not in captured.err


def test_select_refuses_another_tier_with_the_jax_message(hf_dir, exported, capsys):
    _, video, _ = hf_dir
    rc, captured = _select(capsys, exported[0], video, "--quantize", "int4")
    assert rc != 0
    assert "saved with quantize='act8'; requested 'int4'" in captured.err


def test_select_refuses_a_jax_directory_naming_the_remedy(hf_dir, tmp_path_factory, capsys):
    _, video, _ = hf_dir
    rc, captured = _select(capsys, jax_dir(tmp_path_factory, "int8"), video)
    assert rc == 2
    assert "orbax" in captured.err and "videoitg-torch-select" in captured.err
    assert "--export-serving" in captured.err


def test_the_videoitg_adapter_loads_a_serving_checkpoint(exported, tmp_path):
    from videoitg_tpu_torch.eval.api import get_adapter

    adapter = get_adapter("videoitg")(pretrained=exported[0], device="cpu", num_frames=6,
                                      target_fps=4, dtype="float32", quantize_int4=True,
                                      output_dir=str(tmp_path))
    q = adapter.engine.model.lm.layers[0].q
    assert isinstance(q, QuantLinear) and q.bits == 8 and q.w_qt.dtype == torch.int8
    assert q.act_q  # the saved act8 tier, not the int4 asked for


# ---- LoRA for serving ----


def _lora_run():
    _, model = bridged_pair(tiny_params(seed=21))
    lora.add_lora(model, torch.Generator().manual_seed(1), rank=4)
    tx = lora.make_lora_optimizer(model, learning_rate=5e-2, total_steps=3, warmup_ratio=0.0)
    return train_step.create_train_state(model, tx), train_step.make_train_step(CFG, tx, hw=2)


@pytest.mark.parametrize("tier", [None, "int8"], ids=str)
def test_a_merged_lora_run_exports_for_serving(tmp_path, tier):
    """Train steps -> TrainCheckpointer -> restore -> merge_lora (->
    the tier) -> save_serving_checkpoint: the served model scores as the
    runtime adapters did (merged), or as the quantised merged model."""
    state, step_fn = _lora_run()
    saver = checkpointing.TrainCheckpointer(str(tmp_path / "run"), save_interval=3)
    for i in range(3):
        state, _ = train_step.run_step(step_fn, state, make_batches(CFG, 60 + i, "features")[1])
        saver.maybe_save(state.step, state)
    template, _ = _lora_run()
    step, restored = checkpointing.TrainCheckpointer(str(tmp_path / "run")).restore_latest(
        template)
    assert step == 3
    model = restored.model
    runtime = port_select(model).raw_scores
    base = port_select(bridged_pair(tiny_params(seed=21))[1]).raw_scores
    assert np.abs(runtime - base).max() > 1e-5  # the adapters changed the scores
    lora.merge_lora(model)
    assert not any(has_lora(m) for m in model.modules() if hasattr(m, "lora_a"))
    if tier:
        apply_quantization_tier(model, tier)
    want = port_select(model)
    ckpt.save_serving_checkpoint(model, CFG, str(tmp_path / "srv"), quantize=tier)
    loaded, _, _ = ckpt.load_serving_checkpoint(str(tmp_path / "srv"), device="cpu")
    got = port_select(loaded)
    assert np.array_equal(got.raw_scores, want.raw_scores) and got.index == want.index
    if tier is None:
        np.testing.assert_allclose(got.raw_scores, runtime, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_an_unmerged_qlora_model_round_trips_bit_equal(tmp_path, tier):
    model = port_model(tier, seed=22)
    lora.add_lora(model, torch.Generator().manual_seed(2), rank=4)
    gen = torch.Generator().manual_seed(3)
    for layer in model.lm.layers:  # B != 0, so that the adapters count
        layer.q.lora_b.data = torch.randn(layer.q.lora_b.shape, generator=gen) * 0.05
    ckpt.save_serving_checkpoint(model, CFG, str(tmp_path), quantize=tier)
    refs, _ = ckpt._safetensors_index(str(tmp_path / "params.safetensors"))
    assert refs["lm.layers.q.lora_a"].shape == (CFG.lm.num_layers, CFG.lm.hidden_size, 4)
    loaded, _, _ = ckpt.load_serving_checkpoint(str(tmp_path), device="cpu")
    assert_same_model(loaded, model)
    got, want = port_select(loaded), port_select(model)
    assert np.array_equal(got.raw_scores, want.raw_scores) and got.index == want.index


def test_the_daemon_loads_a_serving_checkpoint(hf_dir, exported):
    from videoitg_tpu_torch.cli.serve import build_engine, build_parser

    _, video, _ = hf_dir
    srv, record = exported
    engine = build_engine(build_parser().parse_args(
        ["--model", srv, "--cpu", "--dtype", "float32", "--num-frames", "6",
         "--target-fps", "2"]), torch.device("cpu"))
    assert engine.model.lm.layers[0].down.act_q
    res = engine.select_from_file(video, "find the rocket")
    assert res.index == record["index"]
    with pytest.raises(SystemExit, match="saved with quantize='act8'; requested 'int8'"):
        build_engine(build_parser().parse_args(["--model", srv, "--cpu", "--quantize", "int8"]),
                     torch.device("cpu"))
