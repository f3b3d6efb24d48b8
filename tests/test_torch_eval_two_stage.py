"""The two-stage pipeline on the port alone, and against the JAX package's.

Stage A (`--model videoitg`) writes the per-doc frame selections, stage B (a
downstream adapter with `frame_indices_jsonl=`) answers on them. First the
JAX CLI's own two-stage test (tests/test_cli.py::test_cli_evaluate_two_stage)
with `python -m videoitg_tpu_torch.cli.evaluate` in two child processes, then
stage B through the native `videoitg-vlm`, then both stages in process on
bridged weights: the port's reports equal the JAX package's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from videoitg_tpu.eval.api import get_adapter as jax_get_adapter
from videoitg_tpu.eval.api import get_task as jax_get_task
from videoitg_tpu.eval.harness import ResultsWriter as JaxResultsWriter
from videoitg_tpu.eval.harness import evaluate_task as jax_evaluate_task
from videoitg_tpu_torch.checkpoint import params_from_numpy
from videoitg_tpu_torch.data.video import write_test_video
from videoitg_tpu_torch.eval.api import get_adapter, get_task
from videoitg_tpu_torch.eval.harness import ResultsWriter, evaluate_task

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_A_ARGS = "random_init=True,preset=tiny,num_frames=4,target_fps=1,dtype=float32"


def _run(args, cwd):
    r = subprocess.run([sys.executable, "-m", "videoitg_tpu_torch.cli.evaluate", *args],
                       cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, f"{args}\nSTDOUT:{r.stdout[-2000:]}\nSTDERR:{r.stderr[-2000:]}"
    return r


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    # the fixture of tests/test_cli.py
    d = tmp_path_factory.mktemp("two_stage")
    os.makedirs(d / "root" / "data")
    for i in range(2):
        write_test_video(str(d / "root" / "data" / f"vid{i}.mp4"), 64, 48, 30, 10, 8)
    docs = [{"videoID": f"vid{i}", "question_id": f"q{i}", "question": "Q?",
             "options": ["A. x", "B. y", "C. z", "D. w"], "answer": "A",
             "duration": "short", "domain": "d", "sub_category": "s",
             "task_type": "t"} for i in range(2)]
    (d / "docs.json").write_text(json.dumps(docs))
    return d


@pytest.fixture(scope="module")
def stage_a(workdir):
    _run(["--cpu", "--model", "videoitg", "--model_args", STAGE_A_ARGS,
          "--tasks", "videomme", "--data_root", "root",
          "--docs_json", "docs.json", "--output_path", "outA"], cwd=workdir)
    path = workdir / "outA" / "videomme" / "results.jsonl"
    assert path.exists()
    return [json.loads(x) for x in open(path)]


def test_cli_evaluate_two_stage(workdir, stage_a):
    """tests/test_cli.py::test_cli_evaluate_two_stage with the port's CLI."""
    _run(["--cpu", "--model", "echo-answer",
          "--model_args", "frame_indices_jsonl=outA/videomme/results.jsonl,num_frame=2",
          "--tasks", "videomme", "--data_root", "root",
          "--docs_json", "docs.json", "--output_path", "outB", "--log_samples"], cwd=workdir)
    report = json.loads((workdir / "outB" / "videomme" / "report.videomme.json").read_text())
    assert report["metrics"]["videomme_perception_score"] == 100.0
    assert report["metadata"]["backend"] == "cpu" and "torch_version" in report["metadata"]
    samples = [json.loads(x) for x in open(
        workdir / "outB" / "videomme" / "samples.rank0.videomme.jsonl")]
    for s, r in zip(samples, stage_a):
        ids = json.loads(s["response"].split("frames=")[1].rstrip(")"))
        assert ids == sorted(r["index"][:2])


def test_cli_stage_b_through_the_native_vlm(workdir, stage_a):
    _run(["--cpu", "--model", "videoitg-vlm", "--model_args",
          "frame_indices_jsonl=outA/videomme/results.jsonl,num_frame=3,random_init=True,"
          "preset=tiny,dtype=float32,max_new_tokens=4",
          "--tasks", "videomme", "--data_root", "root",
          "--docs_json", "docs.json", "--output_path", "outV", "--log_samples"], cwd=workdir)
    out = workdir / "outV" / "videomme"
    report = json.loads((out / "report.videomme.json").read_text())
    assert report["num_docs"] == 2 and report["metadata"]["model"] == "videoitg-vlm"
    samples = [json.loads(x) for x in open(out / "samples.rank0.videomme.jsonl")]
    assert len(samples) == 2 and all(isinstance(s["response"], str) for s in samples)


def test_port_two_stage_reports_equal_the_jax_package(tmp_path, workdir):
    """Both stages on each package, the JAX weights bridged into the port's
    adapters: the same stage-A rows, and the same stage-B reports through
    echo-answer and videoitg-vlm."""
    docs = json.loads((workdir / "docs.json").read_text())
    docs += [dict(docs[0], question_id="q2", answer="B"), dict(docs[1], question_id="q3")]
    root = str(workdir / "root")
    kw = dict(random_init=True, preset="tiny", num_frames=4, target_fps=1, dtype="float32",
              data_root=root)
    jax_a = jax_get_adapter("videoitg")(**kw)
    port_a = get_adapter("videoitg")(device="cpu", **kw)
    port_a.engine.model = params_from_numpy(jax.tree.map(np.asarray, jax_a.engine.params),
                                            port_a.engine.cfg).eval()
    jax_evaluate_task(jax_a, jax_get_task("videomme"), docs, str(tmp_path / "jax_a"))
    evaluate_task(port_a, get_task("videomme"), docs, str(tmp_path / "port_a"))
    jax_rows = JaxResultsWriter(str(tmp_path / "jax_a"), 0, 1).merge()
    port_rows = ResultsWriter(str(tmp_path / "port_a"), 0, 1).merge()
    assert open(port_rows).read() == open(jax_rows).read()

    stage_b = {"echo-answer": dict(num_frame=2),
               "videoitg-vlm": dict(num_frame=3, random_init=True, preset="tiny",
                                    dtype="float32", max_new_tokens=6)}
    for name, b_kw in stage_b.items():
        b_kw = dict(b_kw, data_root=root)
        jax_b = jax_get_adapter(name)(frame_indices_jsonl=jax_rows, **b_kw)
        port_b = get_adapter(name)(frame_indices_jsonl=port_rows, device="cpu", **b_kw)
        if name == "videoitg-vlm":
            port_b.model = params_from_numpy(jax.tree.map(np.asarray, jax_b.params),
                                             port_b.cfg).eval()
        want = jax_evaluate_task(jax_b, jax_get_task("videomme"), docs,
                                 str(tmp_path / f"jax_b_{name}"), log_samples=True)
        got = evaluate_task(port_b, get_task("videomme"), docs,
                            str(tmp_path / f"port_b_{name}"), log_samples=True)
        assert got.metrics == want.metrics and got.num_docs == want.num_docs == 4, name
        assert got.samples == want.samples, name
