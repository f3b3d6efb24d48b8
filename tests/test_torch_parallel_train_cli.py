"""Checkpoints and the training CLI of the port on a mesh of gloo ranks.

A dp2 x tp2 checkpoint (rank 0 writes every leaf whole) resumes on the same
layout with the same next step, bit for bit, and on a whole model with no
mesh with the same next step (tests/test_training.py's sharded round trip).
`python -m videoitg_tpu_torch.cli.train --tp 2` under two processes launched
as torchrun launches them takes three steps and logs the one-process run's
losses and grad_norms; `--pp 2` the same, and its checkpoint resumes in one
process with the one-process run's fourth step; `--dp 2` takes twice the
samples a step; `--precompute-features` on a mesh exits 2 on every rank
(skipped where the libav reader cannot be built, as
tests/test_torch_train_cli.py is).
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_dist import run_world
from _torch_train_mesh import jax_tree, write_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ckpt")
    paths = write_trees(tmp, {"full": jax_tree()})
    return run_world(4, "checkpoint", tmp / "world", tree_path=paths["full"],
                     out_dir=str(tmp / "run"))


def test_checkpoint_resumes_on_the_same_layout_bit_for_bit(ckpt):
    for r in ckpt:
        loss, norm, leaves = r["straight"]
        step, loss_r, norm_r, leaves_r = r["resumed"]
        assert step == 2 and r["restored_moments_equal"]
        assert (loss_r, norm_r) == (loss, norm)
        assert set(leaves_r) == set(leaves)
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(leaves_r[name], leaf, err_msg=name)


def test_checkpoint_resumes_with_no_mesh(ckpt):
    """The file holds whole leaves; a whole model restored from it takes the
    same next step, and each rank's slice of its leaves is the rank's."""
    step, loss, norm, leaves = ckpt[0]["whole"]
    assert step == 2
    full = _whole_model().state_dict()
    assert ckpt[0]["saved_shapes"] == {n: tuple(t.shape) for n, t in full.items()}
    import torch

    from videoitg_tpu_torch.parallel import sharding

    specs = sharding.adapt_specs_to_params(sharding.grounding_param_specs(), _whole_model())
    for r in ckpt:
        _, loss_r, norm_r, leaves_r = r["resumed"]
        np.testing.assert_allclose(loss, loss_r, rtol=1e-6)
        np.testing.assert_allclose(norm, norm_r, rtol=1e-5)
        for name, leaf in leaves_r.items():
            want = sharding.local_slice(name, torch.from_numpy(leaves[name]), specs[name],
                                        r["shape"], r["coords"])
            np.testing.assert_allclose(leaf, want.numpy(), atol=1e-6, err_msg=name)


def _np_tree(tree):
    from _torch_bridge import to_numpy_tree

    return to_numpy_tree(tree)


@functools.lru_cache(maxsize=None)
def _whole_model():
    from _torch_dist import train_cfg
    from videoitg_tpu_torch.checkpoint import params_from_numpy

    return params_from_numpy(_np_tree(jax_tree()), train_cfg())


# ---- the CLI under torchrun-style gloo worlds ----


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from videoitg_tpu_torch.data.video import write_test_video

    root = tmp_path_factory.mktemp("train_cli_mesh")
    try:
        for name, n in (("a.mp4", 40), ("b.mp4", 50)):
            write_test_video(str(root / name), 64, 48, n, 10, 12)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")
    records = [{"video": "a.mp4", "question": "where is the dog?", "clip_num": [0, 2]},
               {"video": "b.mp4", "question": "when does it turn?", "clip_num": [1]},
               {"video": "a.mp4", "question": "what is red?", "clip_num": [1, 3]},
               {"video": "b.mp4", "question": "who waves?", "clip_num": [0]}]
    (root / "ground.json").write_text(json.dumps(records))
    return root


BASE = ["--preset", "tiny", "--random-init", "--data-path", "ground.json", "--image-folder", ".",
        "--video-frames", "4", "--fps", "1", "--num-train-epochs", "4", "--cpu",
        "--learning-rate", "1e-3", "--warmup-ratio", "0", "--lr-scheduler-type", "constant"]


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(workdir, out, flags=(), world=1, steps=3):
    """The CLI in `world` processes with torchrun's environment (none for
    one); every rank's CompletedProcess."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "videoitg_tpu_torch.cli.train", *BASE, "--output-dir", out,
           "--total-steps", str(steps), *flags]
    if world == 1:
        return [subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True,
                               timeout=600)]
    master = str(_free_port())
    procs = [subprocess.Popen(cmd, cwd=workdir, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(env, WORLD_SIZE=str(world), RANK=str(r),
                                                  LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                                                  MASTER_PORT=master))
             for r in range(world)]
    done = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        done.append(subprocess.CompletedProcess(p.args, p.returncode, stdout, stderr))
    return done


def _rows(workdir, out):
    return [json.loads(line) for line in open(workdir / out / "metrics.jsonl")]


@pytest.fixture(scope="module")
def runs(workdir):
    """The one-process runs (batch 1 and 2) and the meshes, all started
    together; then the one-process run and the pp2 run each resumed for a
    fourth step by one process."""
    import concurrent.futures as cf

    jobs = {"plain": ("plain", (), 1), "plain-b2": ("plain-b2",
                                                    ("--per-device-train-batch-size", "2"), 1),
            "tp2": ("tp2", ("--tp", "2"), 2), "pp2": ("pp2", ("--pp", "2", "--tp", "1"), 2),
            "dp2": ("dp2", ("--dp", "2", "--tp", "1"), 2),
            "precompute-tp2": ("precompute-tp2", ("--feature-cache", "fcache-tp2",
                                                  "--precompute-features", "--tp", "2"), 2)}
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(_launch, workdir, *v) for k, v in jobs.items()}
        done = {k: f.result() for k, f in futs.items()}
        futs = {f"{k}-resumed": ex.submit(_launch, workdir, k, steps=4) for k in ("plain", "pp2")}
        done.update({k: f.result() for k, f in futs.items()})
    return done


@pytest.mark.parametrize("mesh,plain", [("tp2", "plain"), ("pp2", "plain"),
                                        ("dp2", "plain-b2")])
def test_cli_trains_on_a_mesh_of_gloo_ranks(workdir, runs, mesh, plain):
    for proc in runs[plain] + runs[mesh]:
        assert proc.returncode == 0, proc.stderr
    want = _rows(workdir, plain)[:3]  # "plain" and "pp2" resume for a fourth step below
    got = _rows(workdir, mesh)[:3]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    leader, *followers = runs[mesh]
    assert "[train] step 3/3" in leader.stdout
    assert all("[train] step" not in p.stdout for p in followers)  # rank 0 logs
    assert "3" in os.listdir(workdir / mesh / "checkpoints")  # rank 0 wrote the final save


def test_a_pipeline_checkpoint_resumes_with_no_mesh(workdir, runs):
    """The pp2 run's checkpoint (each stage's layers and their AdamW moments
    gathered whole by rank 0) resumed by one process takes the fourth step
    that the one-process run's own checkpoint takes."""
    for key in ("plain-resumed", "pp2-resumed"):
        proc, = runs[key]
        assert proc.returncode == 0, proc.stderr
        assert "[train] auto-resumed from step 3" in proc.stdout
    got, want = _rows(workdir, "pp2")[-1], _rows(workdir, "plain")[-1]
    assert got["step"] == want["step"] == 4
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)


def test_precompute_on_a_mesh_is_refused(workdir, runs):
    """Filling the feature cache is a one-device job: on a mesh every rank
    exits 2 before it loads anything, and no cache is written."""
    for proc in runs["precompute-tp2"]:
        assert proc.returncode == 2
        assert "--precompute-features fills the cache on one device" in proc.stderr
    assert not (workdir / "fcache-tp2").exists()
