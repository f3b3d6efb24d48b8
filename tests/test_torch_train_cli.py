"""Checkpointing and the training CLI of the port.

`TrainCheckpointer`: save interval, keep limit, forced final save, and resume
that restores the step, the parameters, Adam's moments and the schedule's
position, so that stopping and continuing equals not stopping, exactly.
`python -m videoitg_tpu_torch.cli.train` runs in child processes with the repo
root on PYTHONPATH, on a two-video synthetic set (skipped where the libav
reader cannot be built); mesh axes above 1 without a torchrun group exit 2
with their message; without a CUDA device and without `--cpu` / `--device
cpu` both CLIs stop.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_bridge import bridged_pair, make_batches, tiny_params
from videoitg_tpu_torch.config import preset
from videoitg_tpu_torch.train import checkpointing, lora, optimizer, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _new_run(kind):
    _, model = bridged_pair(tiny_params(seed=20))
    if kind == "lora":
        lora.add_lora(model, torch.Generator().manual_seed(0), rank=2)
        tx = lora.make_lora_optimizer(model, learning_rate=1e-3, out_proj_lr=1e-3,
                                      total_steps=6, warmup_ratio=0.3)
    else:
        tx = optimizer.make_grounding_optimizer(model, learning_rate=1e-3, total_steps=6,
                                                warmup_ratio=0.3, weight_decay=0.01)
    cfg = preset("tiny")
    return (train_step.create_train_state(model, tx),
            train_step.make_train_step(cfg, tx, hw=2))


@pytest.mark.parametrize("kind", ["full", "lora"])
def test_resume_continues_exactly(tmp_path, kind):
    cfg = preset("tiny")
    batches = [make_batches(cfg, 50 + i, "features")[1] for i in range(5)]
    state, step_fn = _new_run(kind)
    for b in batches:
        state, _ = train_step.run_step(step_fn, state, b)
    straight = {k: v.clone() for k, v in state.model.state_dict().items()}

    state, step_fn = _new_run(kind)
    ckpt = checkpointing.TrainCheckpointer(str(tmp_path), save_interval=3)
    for b in batches[:3]:
        state, _ = train_step.run_step(step_fn, state, b)
        ckpt.maybe_save(state.step, state)
    assert ckpt.latest_step() == 3
    # A fresh process: new model, new optimizer, restored from disk.
    state, step_fn = _new_run(kind)
    step, state = checkpointing.TrainCheckpointer(str(tmp_path)).restore_latest(state)
    assert step == 3 and state.step == 3
    assert state.optimizer.scheduler.last_epoch == 3
    moments = state.optimizer.optimizer.state_dict()["state"]
    assert moments and all(int(s["step"]) == 3 for s in moments.values())
    for b in batches[3:]:
        state, _ = train_step.run_step(step_fn, state, b)
    resumed = state.model.state_dict()
    assert set(resumed) == set(straight)
    for name in straight:
        assert torch.equal(resumed[name], straight[name]), name


def test_interval_keep_limit_and_forced_save(tmp_path):
    state, _ = _new_run("full")
    ckpt = checkpointing.TrainCheckpointer(str(tmp_path), max_to_keep=2, save_interval=2)
    assert ckpt.restore_latest(state) == (None, None) and ckpt.latest_step() is None
    saved = [step for step in range(1, 8) if ckpt.maybe_save(step, state)]
    assert saved == [2, 4, 6] and ckpt.all_steps() == [4, 6]
    assert ckpt.maybe_save(7, state, force=True) and ckpt.all_steps() == [6, 7]
    assert not ckpt.maybe_save(7, state, force=True)  # already on disk
    assert sorted(os.listdir(ckpt.directory)) == ["6", "7"]  # no temporary left behind
    assert ckpt.directory == os.path.join(os.path.abspath(str(tmp_path)), "checkpoints")
    off = checkpointing.TrainCheckpointer(str(tmp_path / "off"), save_interval=0, async_save=True)
    assert not off.maybe_save(5, state) and off.maybe_save(5, state, force=True)
    ckpt.close()


# ---- the CLI ----


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from videoitg_tpu_torch.data.video import write_test_video

    root = tmp_path_factory.mktemp("train_cli")
    try:
        for name, n in (("a.mp4", 40), ("b.mp4", 50)):
            write_test_video(str(root / name), 64, 48, n, 10, 12)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")
    records = [{"video": "a.mp4", "question": "where is the dog?", "clip_num": [0, 2]},
               {"video": "b.mp4", "question": "when does it turn?", "clip_num": [1]}]
    (root / "ground.json").write_text(json.dumps(records))
    return root


BASE = ["--preset", "tiny", "--random-init", "--data-path", "ground.json", "--image-folder", ".",
        "--video-frames", "4", "--fps", "1", "--num-train-epochs", "4"]


def _train(workdir, *flags, cpu=True):
    cmd = [sys.executable, "-m", "videoitg_tpu_torch.cli.train", *BASE, *flags]
    if cpu:
        cmd.append("--cpu")
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True, timeout=600)


def _rows(workdir, out):
    return [json.loads(line) for line in open(workdir / out / "metrics.jsonl")]


@pytest.mark.parametrize("name,flags", [
    ("plain", ()),
    ("lora", ("--lora", "4")),
    ("qlora8", ("--lora", "4", "--quantize-base", "int8")),
    ("qlora4", ("--lora", "4", "--quantize-base", "int4")),
    ("projector", ("--tune-projector-only", "--mm-projector-lr", "1e-3",
                   "--gradient-accumulation-steps", "2", "--lr-scheduler-type", "constant",
                   "--vision-token-num", "36", "--vision-min-num", "2")),
    ("yuv420", ("--pix-fmt", "yuv420")),
])
def test_cli_takes_three_steps(workdir, name, flags):
    proc = _train(workdir, "--total-steps", "3", "--output-dir", name, *flags)
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.startswith("[train] step ")]
    assert len(lines) == 3 and lines[-1].startswith("[train] step 3/3 loss=")
    assert "grad_norm=" in lines[0] and "s/step)" in lines[0]
    rows = _rows(workdir, name)
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert set(rows[0]) == {"step", "time", "loss", "pos_weight", "pos_frac", "grad_norm"}
    assert all(r["loss"] == r["loss"] and r["grad_norm"] > 0 for r in rows)
    assert os.listdir(workdir / name / "checkpoints") == ["3"]  # the forced final save
    assert "done at step 3" in proc.stdout


def test_cli_feature_cache_precompute_then_train(workdir):
    proc = _train(workdir, "--feature-cache", "fcache", "--precompute-features",
                  "--output-dir", "fc")
    assert proc.returncode == 0, proc.stderr
    assert "[feature-cache] done: 0/2 hits" in proc.stdout
    assert len(os.listdir(workdir / "fcache")) == 2
    proc = _train(workdir, "--feature-cache", "fcache", "--feature-cache-dtype", "bf16",
                  "--total-steps", "2", "--output-dir", "fc")
    assert proc.returncode == 0, proc.stderr
    assert len(_rows(workdir, "fc")) == 2 and len(os.listdir(workdir / "fcache")) == 2


def test_cli_resumes_without_a_kill(workdir):
    """Two runs into one output directory: the second picks up at the first's
    last step; metrics append; the keep limit holds."""
    flags = ("--output-dir", "resume", "--save-steps", "1", "--save-total-limit", "2",
             "--lora", "2")
    first = _train(workdir, "--total-steps", "2", *flags)
    assert first.returncode == 0, first.stderr
    second = _train(workdir, "--total-steps", "4", *flags)
    assert second.returncode == 0, second.stderr
    assert "[train] auto-resumed from step 2" in second.stdout
    assert [r["step"] for r in _rows(workdir, "resume")] == [1, 2, 3, 4]
    assert sorted(os.listdir(workdir / "resume" / "checkpoints")) == ["3", "4"]


REFUSED = [
    (("--model", "/no/such/dir"), "--model"),
    (("--objective", "vlm"), "--objective vlm"),
    (("--tp", "2"), "--dp / --tp / --sp / --pp"),
    (("--dp", "2"), "--dp / --tp / --sp / --pp"),
    (("--sp", "4"), "--dp / --tp / --sp / --pp"),
    (("--pp", "2"), "--dp / --tp / --sp / --pp"),
    (("--offload-optimizer",), "--offload-optimizer"),
]


NOW_PORTED = ("--model", "--objective vlm", "--offload-optimizer")


@pytest.mark.parametrize("flags,named", REFUSED)
def test_cli_refuses_what_is_not_ported(capsys, flags, named):
    """Every flag once refused is ported. A mesh above one device with no
    torchrun group open is an error before anything is loaded (exit 2, never
    a one-device run); `--model`, the VLM objective and the optimizer offload
    open no mesh."""
    from videoitg_tpu_torch.cli.train import build_parser, main
    from videoitg_tpu_torch.parallel.mesh import open_cli_mesh

    argv = ["--random-init", "--data-path", "x.json", "--image-folder", ".", "--cpu", *flags]
    if named in NOW_PORTED:
        assert open_cli_mesh(build_parser().parse_args(argv), "train") == (None, None)
        return
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert named in err and "torchrun" in err and "one process per device" in err


def test_cli_quantize_base_needs_lora_and_random_init_is_required(workdir):
    proc = _train(workdir, "--quantize-base", "int8", "--output-dir", "never")
    assert proc.returncode == 2 and "--quantize-base requires --lora" in proc.stderr
    from videoitg_tpu_torch.cli.train import main

    assert main(["--data-path", "x.json", "--image-folder", ".", "--cpu"]) == 2


def test_both_clis_stop_without_a_cuda_device(tmp_path):
    """No card and no request for the CPU: a clear error and a non-zero exit,
    never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    env = dict(os.environ, PYTHONPATH=REPO)
    train = subprocess.run(
        [sys.executable, "-m", "videoitg_tpu_torch.cli.train", "--preset", "tiny",
         "--random-init", "--data-path", "x.json", "--image-folder", ".",
         "--output-dir", str(tmp_path / "out")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    select = subprocess.run(
        [sys.executable, "-m", "videoitg_tpu_torch.cli.select", "--preset", "tiny",
         "--random-init", "--video", "x.mp4", "--prompt", "what?"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    for proc, flag in ((train, "--cpu"), (select, "--device cpu")):
        assert proc.returncode != 0
        assert "no CUDA device found" in proc.stderr and flag in proc.stderr
    assert not (tmp_path / "out").exists()
