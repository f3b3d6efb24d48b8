"""The port imports without jax, without the JAX package `videoitg_tpu` and
without the CUDA toolkit.

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
        "foreign = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'videoitg_tpu'))\n"
        "print(json.dumps({'foreign': foreign, 'built': _build._lib is not None}))\n")
    # No compiler anywhere: the kernel modules must still import (lazy build).
    proc = _run(code, VIDEOITG_NVCC=str(tmp_path / "no-nvcc"), PATH="/usr/bin:/bin",
                VIDEOITG_TORCH_BUILD_DIR=str(tmp_path / "build"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"foreign": [], "built": False}
    assert not (tmp_path / "build").exists()


def test_training_modules_load_no_jax_optax_orbax(tmp_path):
    """The training slice's modules, imported alone in a fresh interpreter
    with no compiler on the path: no jax, optax, orbax or `videoitg_tpu`
    comes with them, and nothing is built."""
    mods = [m for m in _modules() if ".train" in m or m.endswith(
        ("ops.flash_attention_train", "utils.metrics_logger", "checkpoint"))]
    assert {"videoitg_tpu_torch.train.lora", "videoitg_tpu_torch.train.optimizer",
            "videoitg_tpu_torch.train.train_step", "videoitg_tpu_torch.train.collate",
            "videoitg_tpu_torch.train.dataset", "videoitg_tpu_torch.train.feature_cache",
            "videoitg_tpu_torch.train.checkpointing", "videoitg_tpu_torch.cli.train",
            "videoitg_tpu_torch.ops.flash_attention_train"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from videoitg_tpu_torch.ops import _build\n"
        "bad = ('jax', 'jaxlib', 'optax', 'orbax', 'flax', 'videoitg_tpu')\n"
        "foreign = sorted(k for k in sys.modules if k.split('.')[0] in bad)\n"
        "print(json.dumps({'foreign': foreign, 'built': _build._lib is not None}))\n")
    proc = _run(code, VIDEOITG_NVCC=str(tmp_path / "no-nvcc"), PATH="/usr/bin:/bin",
                VIDEOITG_TORCH_BUILD_DIR=str(tmp_path / "build"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"foreign": [], "built": False}


def test_serving_modules_load_no_jax(tmp_path):
    """The serving slice's modules (daemon, decode-ahead, frame cache, the
    splash arm, the repro kernels), imported alone in a fresh interpreter with
    no compiler on the path: neither jax nor `videoitg_tpu` comes with them,
    and nothing is built."""
    mods = ["videoitg_tpu_torch.cli.serve", "videoitg_tpu_torch.data.prefetch",
            "videoitg_tpu_torch.data.frame_cache", "videoitg_tpu_torch.ops.splash_attention",
            "videoitg_tpu_torch.ops.repro_kernels", "videoitg_tpu_torch.ops.preprocess"]
    assert set(mods) <= set(_modules())
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from videoitg_tpu_torch.cli.serve import build_parser, SelectionServer, make_handler\n"
        "build_parser().parse_args(['--cpu', '--transfer', 'yuv420'])\n"
        "from videoitg_tpu_torch.ops import _build\n"
        "foreign = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'videoitg_tpu'))\n"
        "print(json.dumps({'foreign': foreign, 'built': _build._lib is not None}))\n")
    proc = _run(code, VIDEOITG_NVCC=str(tmp_path / "no-nvcc"), PATH="/usr/bin:/bin",
                VIDEOITG_TORCH_BUILD_DIR=str(tmp_path / "build"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"foreign": [], "built": False}
    assert not (tmp_path / "build").exists()


def test_vlm_modules_load_no_jax(tmp_path):
    """The causal-VLM slice's modules (the model, its SFT pipeline, the
    optimizer offload, the conversation templates, the segment-id attention
    kernels' wrapper), imported alone in a fresh interpreter with no compiler
    on the path: no jax, optax, orbax or `videoitg_tpu` comes with them, the
    train CLI parses the VLM flags, and nothing is built."""
    mods = ["videoitg_tpu_torch.models.vlm", "videoitg_tpu_torch.train.vlm_sft",
            "videoitg_tpu_torch.train.offload", "videoitg_tpu_torch.data.conversation",
            "videoitg_tpu_torch.ops.flash_attention_segment", "videoitg_tpu_torch.cli.train"]
    assert set(mods) <= set(_modules())
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from videoitg_tpu_torch.cli.train import build_parser, _refusal\n"
        "args = build_parser().parse_args(['--data-path', 'x', '--image-folder', '.', "
        "'--objective', 'vlm', '--conv-template', 'chatml', '--offload-optimizer', '--cpu'])\n"
        "assert _refusal(args) is None\n"
        "from videoitg_tpu_torch.ops import _build\n"
        "bad = ('jax', 'jaxlib', 'optax', 'orbax', 'flax', 'videoitg_tpu')\n"
        "foreign = sorted(k for k in sys.modules if k.split('.')[0] in bad)\n"
        "print(json.dumps({'foreign': foreign, 'built': _build._lib is not None}))\n")
    proc = _run(code, VIDEOITG_NVCC=str(tmp_path / "no-nvcc"), PATH="/usr/bin:/bin",
                VIDEOITG_TORCH_BUILD_DIR=str(tmp_path / "build"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"foreign": [], "built": False}
    assert not (tmp_path / "build").exists()


def test_the_guard_sees_the_jax_package():
    """The same scan must report `videoitg_tpu` as it reports `jax`."""
    code = ("import sys, json, videoitg_tpu.constants\n"
            "print(json.dumps(sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('jax', 'jaxlib', 'videoitg_tpu'))))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "videoitg_tpu" in json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_source_line_imports_jax_or_the_jax_package():
    import re

    pattern = re.compile(r"^\s*(from|import) +(jax|videoitg_tpu)(\.|\s|$)")
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "torch_repro_kernels.py"),
             os.path.join(REPO, "scripts", "torch_profile_request.py")]
    for root, _, files in os.walk(os.path.join(REPO, "videoitg_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    hits = []
    for path in paths:
        with open(path) as f:
            hits += [f"{path}:{i}" for i, line in enumerate(f, 1) if pattern.match(line)]
    assert len(paths) > 20 and not hits, hits


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
