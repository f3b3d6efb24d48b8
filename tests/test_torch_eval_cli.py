"""The port's evaluate CLI (`python -m videoitg_tpu_torch.cli.evaluate`) in a
child process, with the arguments of the JAX CLI's own tests
(tests/test_cli.py, tests/test_observability.py) and `--model videoitg`; and
the two-stage contract: the port's stage-A `results.jsonl` feeds the port's
stage B (`echo-answer`, in process) to the report that the JAX stage A's rows
give. tests/test_torch_eval_two_stage.py runs both stages on the port alone.
"""

import json
import os
import sqlite3
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
from videoitg_tpu_torch.cli.evaluate import build_parser, main
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
    d = tmp_path_factory.mktemp("cli")
    os.makedirs(d / "root" / "data")
    for i in range(2):
        write_test_video(str(d / "root" / "data" / f"vid{i}.mp4"), 64, 48, 30, 10, 8)
    docs = [{"videoID": f"vid{i}", "question_id": f"q{i}", "question": "Q?",
             "options": ["A. x", "B. y", "C. z", "D. w"], "answer": "A",
             "duration": "short", "domain": "d", "sub_category": "s",
             "task_type": "t"} for i in range(2)]
    (d / "docs.json").write_text(json.dumps(docs))
    return d


def _stage_b(selections, data_root, docs, out):
    """The port's downstream stage on a results.jsonl, in process."""
    adapter = get_adapter("echo-answer")(frame_indices_jsonl=selections, num_frame=2,
                                         data_root=data_root, device="cpu")
    return evaluate_task(adapter, get_task("videomme"), docs, out, log_samples=True)


def test_parser_has_the_jax_cli_flags():
    from videoitg_tpu.cli.evaluate import build_parser as jax_build_parser

    def flags(parser):
        return sorted(a.dest for a in parser._actions if a.dest != "help")

    assert flags(build_parser()) == flags(jax_build_parser())
    assert len(flags(build_parser())) == 26


def test_stage_a_in_a_child_process_feeds_jax_stage_b(workdir):
    _run(["--cpu", "--model", "videoitg", "--model_args", STAGE_A_ARGS,
          "--tasks", "videomme", "--data_root", "root",
          "--docs_json", "docs.json", "--output_path", "outA"], cwd=workdir)
    out = workdir / "outA" / "videomme"
    rows = [json.loads(x) for x in open(out / "results.jsonl")]
    assert [r["doc_id"] for r in rows] == [0, 1]
    for r in rows:
        assert set(r) == {"index", "logits", "num_frames", "contexts", "video_path", "doc_id"}
        assert sorted(r["index"]) == [0, 10, 20] and r["logits"] == sorted(r["logits"])[::-1]
    report = json.loads((out / "report.videomme.json").read_text())
    assert report["metadata"]["backend"] == "cpu" and "torch_version" in report["metadata"]
    docs = json.loads((workdir / "docs.json").read_text())
    b = _stage_b(str(out / "results.jsonl"), str(workdir / "root"), docs,
                 str(workdir / "outB"))
    assert b.metrics["videomme_perception_score"] == 100.0
    for s, r in zip(b.samples, rows):
        assert json.loads(s["response"].split("frames=")[1].rstrip(")")) == sorted(r["index"][:2])


def test_use_cache_and_metadata(workdir):
    cmd = ["--cpu", "--model", "videoitg", "--model_args", STAGE_A_ARGS,
           "--tasks", "videomme", "--data_root", "root", "--docs_json", "docs.json",
           "--output_path", "outC", "--use_cache", "cache.sqlite", "--seed", "99"]
    _run(cmd, cwd=workdir)
    report = json.loads((workdir / "outC" / "videomme" / "report.videomme.json").read_text())
    meta = report["metadata"]
    assert meta["model"] == "videoitg" and meta["seed"] == 99
    assert "git_hash" in meta and "date" in meta and "torch_version" in meta
    assert "jax_version" not in meta

    def count():
        return sqlite3.connect(workdir / "cache.sqlite").execute(
            "SELECT COUNT(*) FROM responses").fetchone()[0]

    assert count() == 2
    # the rerun is served from the cache: the adapter scores nothing, so no
    # selection row is written, and the report is the same
    cmd[cmd.index("outC")] = "outC2"
    _run(cmd, cwd=workdir)
    assert count() == 2
    assert not (workdir / "outC2" / "videomme" / "results.rank0.jsonl").exists()
    again = json.loads((workdir / "outC2" / "videomme" / "report.videomme.json").read_text())
    assert again["metrics"] == report["metrics"] and again["num_docs"] == 2


def test_cache_requests(workdir):
    import shutil

    root2 = workdir / "root2"
    root2.mkdir(exist_ok=True)
    shutil.copy(workdir / "docs.json", root2 / "test.json")
    shutil.copytree(workdir / "root" / "data", root2 / "data", dirs_exist_ok=True)
    cache_dir = workdir / "reqcache"
    cmd = ["--cpu", "--model", "videoitg", "--model_args", STAGE_A_ARGS,
           "--tasks", "videomme", "--data_root", str(root2),
           "--output_path", "outR", "--cache_requests", str(cache_dir)]
    first = _run(cmd, cwd=workdir)
    assert "from request cache" not in first.stdout
    assert len(list(cache_dir.glob("docs.videomme.*.json"))) == 1
    r = _run(cmd, cwd=workdir)
    assert "loaded 2 docs from request cache" in r.stdout


def test_fewshot_docs_json_does_not_hit_task_loader(workdir):
    docs = [{"question": f"What is {i}+{i}?", "answer": f"Sum it. #### {2 * i}"}
            for i in range(7)]
    (workdir / "gsm_docs.json").write_text(json.dumps(docs))
    r = _run(["--cpu", "--model", "videoitg", "--model_args", STAGE_A_ARGS,
              "--tasks", "gsm8k", "--docs_json", "gsm_docs.json", "--num_fewshot", "2",
              "--output_path", "outg", "--predict_only"], cwd=workdir)
    assert "fewshot exemplars drawn from the provided docs" in r.stdout
    samples = (workdir / "outg" / "gsm8k" / "samples.rank0.gsm8k.jsonl").read_text()
    assert len(samples.strip().splitlines()) == 7


def test_report_to_jsonl_writes_the_metrics_stream(workdir):
    _run(["--cpu", "--model", "videoitg", "--model_args", STAGE_A_ARGS,
          "--tasks", "videomme", "--data_root", "root", "--docs_json", "docs.json",
          "--output_path", "outM", "--report_to", "jsonl"], cwd=workdir)
    rows = [json.loads(x) for x in open(workdir / "outM" / "metrics.jsonl")]
    assert any("videomme/videomme_perception_score" in row for row in rows)


@pytest.mark.parametrize("argv,needle", [
    (["--model", "echo-answer", "--model_args", "num_frame=2"], "A (frames=[0, 29])"),
    (["--model", "videoitg-vlm", "--model_args",
      "num_frame=2,random_init=True,preset=tiny,dtype=float32,max_new_tokens=3"], None),
], ids=["echo-answer", "videoitg-vlm"])
def test_adapters_not_ported_are_refused(workdir, tmp_path, argv, needle):
    """The stage-B names once refused (ROADMAP items 5b and 5c) run through
    `main` in this process, on the CPU, with no stage-A rows (the uniform
    fallback)."""
    out = tmp_path / "out"
    assert main([*argv, "--cpu", "--tasks", "videomme", "--data_root",
                 str(workdir / "root"), "--docs_json", str(workdir / "docs.json"),
                 "--output_path", str(out), "--log_samples"]) == 0
    samples = [json.loads(x) for x in open(out / "videomme" / "samples.rank0.videomme.jsonl")]
    assert len(samples) == 2 and all(isinstance(s["response"], str) for s in samples)
    if needle:
        assert [s["response"] for s in samples] == [needle, needle]


def test_the_card_or_an_error(workdir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device found.*pass --cpu"):
        main(["--model", "videoitg", "--model_args", STAGE_A_ARGS, "--tasks", "videomme",
              "--docs_json", str(workdir / "docs.json")])


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("mesh", ["", ",tp=2"])
def test_one_torch_distributed_group_merges_through_the_collective(workdir, mesh):
    """Two gloo processes, launched as torchrun launches them (WORLD_SIZE,
    RANK, MASTER_ADDR / MASTER_PORT in the environment), each evaluate their
    doc shard and merge through the collective: rank 0's report counts every
    doc and no rank waited on a sentinel (tests/test_multihost.py). With the
    adapter on a tp=2 mesh over the group, both ranks score every doc in step
    and rank 0 alone writes."""
    args = build_parser().parse_args(["--model", "videoitg", "--tasks", "videomme"])
    assert args.rank is None and args.world_size is None
    port = _free_port()
    out_name = "outMH" + mesh.replace(",", "_").replace("=", "")
    cmd = [sys.executable, "-m", "videoitg_tpu_torch.cli.evaluate", "--cpu",
           "--model", "videoitg", "--model_args", STAGE_A_ARGS + mesh, "--tasks", "videomme",
           "--data_root", "root", "--docs_json", "docs.json", "--output_path", out_name]
    procs = [subprocess.Popen(cmd, cwd=workdir, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE="2",
                                                  RANK=str(r), LOCAL_RANK=str(r),
                                                  MASTER_ADDR="localhost",
                                                  MASTER_PORT=str(port)))
             for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"STDOUT:{out[-2000:]}\nSTDERR:{err[-2000:]}"
    out = workdir / out_name / "videomme"
    report = json.loads((out / "report.videomme.json").read_text())
    shards = 1 if mesh else 2
    assert report["num_docs"] == 2 and report["metadata"]["world_size"] == shards
    assert [json.loads(x)["doc_id"] for x in open(out / "results.jsonl")] == [0, 1]
    n = sum(1 for r in range(shards) for _ in open(out / f"records.rank{r}.videomme.jsonl"))
    assert n == 2
    assert not (out / f"records.rank{shards}.videomme.jsonl").exists()


def test_rank_fleet_through_the_shared_directory(workdir):
    """Two ranks launched separately (no collective) shard the docs; rank 0
    merges them through the shared output directory."""
    base = ["--cpu", "--model", "videoitg", "--model_args", STAGE_A_ARGS,
            "--tasks", "videomme", "--data_root", "root", "--docs_json", "docs.json",
            "--output_path", "outF", "--world_size", "2"]
    _run([*base, "--rank", "1"], cwd=workdir)
    _run([*base, "--rank", "0"], cwd=workdir)
    out = workdir / "outF" / "videomme"
    assert [json.loads(x)["doc_id"] for x in open(out / "results.jsonl")] == [0, 1]
    assert json.loads((out / "report.videomme.json").read_text())["num_docs"] == 2


def test_port_stage_a_feeds_jax_stage_b_to_the_same_report(tmp_path, workdir):
    """On bridged weights, stage B (the port's echo-answer) reads the port's
    rows and the JAX rows to the same report and the same consumed frames,
    doc by doc."""
    docs = json.loads((workdir / "docs.json").read_text())
    docs += [dict(docs[0], question_id="q2", answer="B"), dict(docs[1], question_id="q3")]
    root = str(workdir / "root")
    kw = dict(random_init=True, preset="tiny", num_frames=4, target_fps=1,
              dtype="float32", data_root=root)
    jax_adapter = jax_get_adapter("videoitg")(**kw)
    jax_evaluate_task(jax_adapter, jax_get_task("videomme"), docs, str(tmp_path / "jax_a"))
    port = get_adapter("videoitg")(device="cpu", **kw)
    port.engine.model = params_from_numpy(jax.tree.map(np.asarray, jax_adapter.engine.params),
                                          port.engine.cfg).eval()
    evaluate_task(port, get_task("videomme"), docs, str(tmp_path / "port_a"))
    jax_rows = JaxResultsWriter(str(tmp_path / "jax_a"), 0, 1).merge()
    port_rows = ResultsWriter(str(tmp_path / "port_a"), 0, 1).merge()
    want = _stage_b(jax_rows, root, docs, str(tmp_path / "jax_b"))
    got = _stage_b(port_rows, root, docs, str(tmp_path / "port_b"))
    assert got.metrics == want.metrics and got.num_docs == want.num_docs == 4
    assert got.samples == want.samples
    assert want.metrics["videomme_perception_score"] == 75.0
