"""The port imports without jax and without the CUDA toolkit.

Runs in fresh interpreters with `cwd` the repo root and `PYTHONPATH` set to
it, so the result does not depend on an installed package or on what the
test process has already imported.
"""

import json
import os
import pkgutil
import subprocess
import sys

import videoitg_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env_extra) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        videoitg_tpu_torch.__path__, prefix="videoitg_tpu_torch."))


def test_every_module_imports_without_jax(tmp_path):
    mods = _modules()
    assert "videoitg_tpu_torch.engine" in mods and "videoitg_tpu_torch.cli.select" in mods
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from videoitg_tpu_torch.ops import _build\n"
        "print(json.dumps({'jax': sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')),"
        " 'built': _build._lib is not None}))\n")
    # No compiler anywhere: the kernel modules must still import (lazy build).
    proc = _run(code, VIDEOITG_NVCC=str(tmp_path / "no-nvcc"), PATH="/usr/bin:/bin",
                VIDEOITG_TORCH_BUILD_DIR=str(tmp_path / "build"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"jax": [], "built": False}
    assert not (tmp_path / "build").exists()


def test_cli_runs_as_a_module(tmp_path):
    from videoitg_tpu.data.video import write_test_video

    path = write_test_video(str(tmp_path / "v.mp4"), 100, 76, 20, 10, 8)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "videoitg_tpu_torch.cli.select", "--preset", "tiny",
         "--random-init", "--video", path, "--prompt", "what?", "--device", "cpu",
         "--num-frames", "8", "--target-fps", "10", "--json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(record["index"]) == 8 and record["contexts"] == "what?"
