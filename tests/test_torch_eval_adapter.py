"""Stage A of eval on the port against the JAX package: the `videoitg`
adapter writes the same `results.jsonl` rows and report metrics.

Both adapters are built with `random_init=True` on `preset("tiny")` in fp32
on the CPU; the JAX adapter's params cross into the port adapter's engine
through the bridge (`checkpoint.params_from_numpy`). The videos are the
Video-MME fixture of tests/test_eval_harness.py (4 clips of 4 to 7 sampled
frames), written by the port's `write_test_video`, with two more questions
on the first video and one doc whose video does not decode. Dense rows must be
equal: index, logits (the file's 2 decimals), contexts, video_path and
doc_id. The quantised tiers are held to the tolerances of
tests/test_torch_quant.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from videoitg_tpu.eval.api import get_adapter as jax_get_adapter
from videoitg_tpu.eval.api import get_task as jax_get_task
from videoitg_tpu.eval.harness import ResultsWriter as JaxResultsWriter
from videoitg_tpu.eval.harness import evaluate_task as jax_evaluate_task
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.data.video import write_test_video
from videoitg_tpu_torch.eval.api import get_adapter, get_task
from videoitg_tpu_torch.eval.harness import ResultsWriter, evaluate_task
from videoitg_tpu_torch.ops import quant

BASE = dict(random_init=True, preset="tiny", num_frames=8, target_fps=1, dtype="float32")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    # Video-MME layout: <root>/data/<videoID>.mp4
    root = tmp_path_factory.mktemp("videomme_root")
    os.makedirs(root / "data")
    for i in range(4):
        write_test_video(str(root / "data" / f"vid{i}.mp4"), 64, 48, 40 + i * 10, 10, 8)
    (root / "data" / "broken.mp4").write_bytes(b"not a video" * 100)
    return str(root)


def _docs(with_extras=True):
    docs = [{"videoID": f"vid{i}", "question_id": f"q{i}",
             "question": f"What color is frame {i}?",
             "options": ["A. red", "B. green", "C. blue", "D. black"],
             "answer": "A" if i % 2 == 0 else "B",
             "duration": ["short", "medium", "long", "short"][i],
             "domain": "TV", "sub_category": "x", "task_type": "t"} for i in range(4)]
    if with_extras:
        # two more questions on vid0 (select_many), one video that does not decode
        docs += [dict(docs[0], question_id=f"q0{j}", question=f"What moves in scene {j}?",
                      answer="C") for j in range(2)]
        docs.append(dict(docs[1], videoID="broken", question_id="qb"))
    return docs


def _rows(out):
    path = os.path.join(out, "results.jsonl")
    return [json.loads(line) for line in open(path)]


def _bridge(jax_adapter, port_adapter):
    """The JAX adapter's weights (any tier) into the port adapter's engine."""
    engine = port_adapter.engine
    tree = jax.tree.map(np.asarray, jax_adapter.engine.params)
    engine.model = params_from_numpy(tree, engine.cfg).to(engine.device).eval()
    return engine.model


def _run_both(tmp_path, data_root, docs, limit=None, port_only_kw=None, **kw):
    kw = dict(BASE, data_root=data_root, **kw)
    jax_adapter = jax_get_adapter("videoitg")(**kw)
    jax_out = str(tmp_path / "jax")
    want = jax_evaluate_task(jax_adapter, jax_get_task("videomme"), docs, jax_out,
                             limit=limit, log_samples=True)
    JaxResultsWriter(jax_out, 0, 1).merge()
    kw.update(port_only_kw or {})
    if "frame_cache_dir" in kw:
        kw["frame_cache_dir"] += "-port"
    port_adapter = get_adapter("videoitg")(device="cpu", **kw)
    _bridge(jax_adapter, port_adapter)
    port_out = str(tmp_path / "port")
    got = evaluate_task(port_adapter, get_task("videomme"), docs, port_out, limit=limit,
                        log_samples=True)
    ResultsWriter(port_out, 0, 1).merge()
    return (want, _rows(jax_out)), (got, _rows(port_out)), port_adapter


CASES = {
    "limit-2": dict(limit=2),
    "batch-1": dict(batch_size=1),
    "batch-2": dict(batch_size=2),
    "frame-cache": dict(frame_cache_dir="fc"),
    "yuv420": dict(transfer="yuv420"),
}


@pytest.mark.parametrize("case", CASES)
def test_stage_a_rows_equal_the_jax_adapter(tmp_path, data_root, case):
    kw = dict(CASES[case])
    limit = kw.pop("limit", None)
    if "frame_cache_dir" in kw:
        kw["frame_cache_dir"] = str(tmp_path / kw["frame_cache_dir"])
    docs = _docs()
    (want, want_rows), (got, got_rows), port_adapter = _run_both(
        tmp_path, data_root, docs, limit=limit, **kw)
    assert got_rows == want_rows
    assert got.metrics == want.metrics and got.num_docs == want.num_docs
    assert got.samples == want.samples
    n_rows = 2 if limit else 6  # every doc but the broken video's
    assert len(got_rows) == n_rows
    assert {r["doc_id"] for r in got_rows} == set(range(n_rows))
    if not limit:
        # three questions of vid0 from one encode, the broken video in both
        assert sum(r["video_path"].endswith("vid0.mp4") for r in got_rows) == 3
        assert [s["response"] for s in got.samples if s["doc_id"] == 6] == ["[decode-error]"]
    if case == "frame-cache":
        # the second run reads every video from the cache: the same rows
        assert len(os.listdir(kw["frame_cache_dir"] + "-port")) == 4
        again = str(tmp_path / "port-again")
        evaluate_task(port_adapter, get_task("videomme"), docs, again)
        assert ResultsWriter(again, 0, 1).merge() and _rows(again) == got_rows


def test_stage_a_resume_appends_nothing_for_done_docs(tmp_path, data_root):
    docs = _docs()
    (_, want_rows), (_, got_rows), port_adapter = _run_both(tmp_path, data_root, docs, limit=3)
    out = str(tmp_path / "port")
    shard = os.path.join(out, "results.rank0.jsonl")
    assert len(open(shard).readlines()) == 3
    # resume: the three done docs are not scored again, the rest are added
    report = evaluate_task(port_adapter, get_task("videomme"), docs, out, log_samples=True)
    lines = open(shard).readlines()
    assert len(lines) == 6 and len({json.loads(x)["doc_id"] for x in lines}) == 6
    evaluate_task(port_adapter, get_task("videomme"), docs, out)
    assert open(shard).readlines() == lines  # everything done: nothing appended
    # the resumed run's rows and report equal a full JAX run's
    jax_adapter = jax_get_adapter("videoitg")(**dict(BASE, data_root=data_root))
    jax_out = str(tmp_path / "jax-full")
    want = jax_evaluate_task(jax_adapter, jax_get_task("videomme"), docs, jax_out)
    JaxResultsWriter(jax_out, 0, 1).merge()
    ResultsWriter(out, 0, 1).merge()
    assert _rows(out) == _rows(jax_out)
    assert report.metrics == want.metrics


# Tolerances of tests/test_torch_quant.py: the weight-only tiers differ from
# JAX by fp32 summation order (2e-5); act8 can round an activation that sits on
# an int8 rounding boundary the other way (1e-2). The rows hold 2-decimal
# scores, so each side's rounding adds up to 0.005.
TIERS = {"int8": (dict(quantize_int8=True), 2e-5), "int4": (dict(quantize_int4=True), 2e-5),
         "act8": (dict(act_int8=True), 1e-2)}


@pytest.mark.parametrize("tier", TIERS)
def test_quantised_tiers_agree_within_their_tolerance(tmp_path, data_root, tier):
    kw, atol = TIERS[tier]
    docs = _docs(with_extras=False)
    (want, want_rows), (got, got_rows), port_adapter = _run_both(
        tmp_path, data_root, docs, **kw)
    model = port_adapter.engine.model
    assert quant.is_quantized_tree(model)
    lin = model.lm.layers[0].q
    assert lin.bits == (4 if tier == "int4" else 8)
    assert lin.act_q == (tier == "act8")
    assert quant.is_quantized(model.vision.layers[0].fc1) == (tier == "act8")
    assert len(got_rows) == len(want_rows) == 4
    worst = 0.0
    for g, w in zip(got_rows, want_rows):
        assert {k: g[k] for k in ("contexts", "video_path", "doc_id", "num_frames")} == \
            {k: w[k] for k in ("contexts", "video_path", "doc_id", "num_frames")}
        assert sorted(g["index"]) == sorted(w["index"])
        gs, ws = dict(zip(g["index"], g["logits"])), dict(zip(w["index"], w["logits"]))
        worst = max(worst, max(abs(gs[i] - ws[i]) for i in gs))
    assert worst <= atol + 0.01 + 1e-9, worst
    assert got.num_docs == want.num_docs == 4


@pytest.mark.parametrize("tier", ["int8", "int4", "act8"])
def test_port_adapter_builds_its_own_tier(data_root, tier):
    """The port adapter's own random model in each tier: int8 drawn directly
    in int8 form (no dense LM), int4 and act8 through the port's tier
    transforms."""
    kw, _ = TIERS[tier]
    adapter = get_adapter("videoitg")(device="cpu", data_root=data_root, **BASE, **kw)
    model = adapter.engine.model
    lin = model.lm.layers[0].down
    assert isinstance(lin, quant.QuantLinear) and lin.bits == (4 if tier == "int4" else 8)
    assert lin.act_q == (tier == "act8")
    assert quant.is_quantized(model.vision.layers[0].fc1) == (tier == "act8")
    if tier == "int8":
        assert torch.all(lin.scale == 0.01)  # ops/quant.init_qwen2_int8's scales
    scores = adapter.engine.select(np.zeros((4, 48, 64, 3), np.uint8), [0, 1, 2, 3], "q")
    assert len(scores.index) == 4 and all(0.0 <= v <= 1.0 for v in scores.logits)


@pytest.mark.parametrize("arg", ["dp", "tp", "sp", "pp"])
def test_device_meshes_are_refused_naming_item_8(data_root, arg):
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item 8\)"):
        get_adapter("videoitg")(device="cpu", data_root=data_root, **BASE, **{arg: 2})
    # one device on the axis is no mesh
    get_adapter("videoitg")(device="cpu", data_root=data_root, **BASE, **{arg: 1})


def test_a_missing_video_raises_alike(tmp_path, data_root):
    """Video-MME's doc_to_visual raises for a file that is not there, in both
    packages, before anything is decoded."""
    docs = [dict(_docs(with_extras=False)[0], videoID="missing")]
    kw = dict(BASE, data_root=data_root)
    with pytest.raises(FileNotFoundError, match="missing.mp4"):
        jax_evaluate_task(jax_get_adapter("videoitg")(**kw), jax_get_task("videomme"), docs,
                          str(tmp_path / "jax"))
    with pytest.raises(FileNotFoundError, match="missing.mp4"):
        evaluate_task(get_adapter("videoitg")(device="cpu", **kw), get_task("videomme"), docs,
                      str(tmp_path / "port"))


def test_serving_checkpoint_is_refused_naming_item_4(tmp_path):
    (tmp_path / "serving_config.json").write_text("{}")
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item 4\)"):
        get_adapter("videoitg")(pretrained=str(tmp_path), device="cpu")


def test_no_card_is_an_error_unless_the_cpu_is_asked_for(data_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device found.*device=cpu"):
        get_adapter("videoitg")(data_root=data_root, **BASE)
    with pytest.raises(ValueError, match="pretrained=DIR or random_init=True"):
        get_adapter("videoitg")(device="cpu")
