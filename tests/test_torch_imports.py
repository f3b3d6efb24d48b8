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
        "from videoitg_tpu_torch.cli.train import build_parser\n"
        "from videoitg_tpu_torch.parallel.mesh import open_cli_mesh\n"
        "args = build_parser().parse_args(['--data-path', 'x', '--image-folder', '.', "
        "'--objective', 'vlm', '--conv-template', 'chatml', '--offload-optimizer', '--cpu'])\n"
        "assert open_cli_mesh(args, 'train') == (None, None)\n"
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


def test_eval_modules_load_no_jax(tmp_path):
    """The eval slice's modules (the harness, the scorers, the task registry
    with every task, the grounding adapter, the evaluate CLI), imported alone
    in a fresh interpreter with no compiler on the path: neither jax nor
    `videoitg_tpu` comes with them, the registries fill, and nothing is
    built."""
    mods = [m for m in _modules() if ".eval" in m] + ["videoitg_tpu_torch.cli.evaluate"]
    assert {"videoitg_tpu_torch.eval.harness", "videoitg_tpu_torch.eval.adapters.videoitg",
            "videoitg_tpu_torch.eval.tasks.videomme", "videoitg_tpu_torch.eval.megabench.scoring",
            "videoitg_tpu_torch.eval.multihost"} <= set(mods)
    assert sum(".eval.tasks." in m for m in mods) == 88
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from videoitg_tpu_torch.eval import api\n"
        "api.get_task('videomme'); api.get_adapter('videoitg')\n"
        "from videoitg_tpu_torch.cli.evaluate import build_parser\n"
        "build_parser().parse_args(['--model', 'videoitg', '--tasks', 'videomme', '--cpu'])\n"
        "from videoitg_tpu_torch.ops import _build\n"
        "bad = ('jax', 'jaxlib', 'optax', 'orbax', 'flax', 'videoitg_tpu')\n"
        "foreign = sorted(k for k in sys.modules if k.split('.')[0] in bad)\n"
        "print(json.dumps({'foreign': foreign, 'built': _build._lib is not None,\n"
        "                  'tasks': len(api.TASK_REGISTRY), 'adapters': sorted(api.ADAPTER_REGISTRY)}))\n")
    proc = _run(code, VIDEOITG_NVCC=str(tmp_path / "no-nvcc"), PATH="/usr/bin:/bin",
                VIDEOITG_TORCH_BUILD_DIR=str(tmp_path / "build"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["foreign"] == [] and out["built"] is False
    assert out["adapters"] == ["api-chat", "echo-answer", "hf-video-llm", "internvl-chat",
                               "llava-ov-chat", "qwen-vl-chat", "videoitg", "videoitg-vlm"]
    assert out["tasks"] > 100
    assert not (tmp_path / "build").exists()


def test_adapters_import_without_transformers_or_pil(tmp_path):
    """The card's machine may lack transformers and PIL: importing every
    adapter, resolving each name and building the models that need neither
    (videoitg-vlm's random tiny model, echo-answer) must work with both
    blocked, and load neither jax nor `videoitg_tpu`."""
    code = (
        "import json, sys\n"
        "sys.modules['transformers'] = None; sys.modules['PIL'] = None\n"
        "import videoitg_tpu_torch.eval.adapters\n"
        "from videoitg_tpu_torch.eval import api\n"
        "names = sorted(api.ADAPTER_REGISTRY)\n"
        "classes = [api.get_adapter(n).__name__ for n in names]\n"
        "api.get_adapter('echo-answer')(device='cpu')\n"
        "a = api.get_adapter('videoitg-vlm')(random_init=True, preset='tiny', device='cpu')\n"
        "try:\n"
        "    api.get_adapter('internvl-chat')(pretrained='x', device='cpu')\n"
        "    hf = 'loaded'\n"
        "except ImportError as e:\n"
        "    hf = type(e).__name__\n"
        "bad = ('jax', 'jaxlib', 'videoitg_tpu')\n"
        "foreign = sorted(k for k in sys.modules if k.split('.')[0] in bad)\n"
        "print(json.dumps({'foreign': foreign, 'names': names, 'classes': classes, 'hf': hf,\n"
        "                  'blocked': [sys.modules[m] is None for m in ('transformers', 'PIL')]}))\n")
    proc = _run(code, VIDEOITG_NVCC=str(tmp_path / "no-nvcc"), PATH="/usr/bin:/bin",
                VIDEOITG_TORCH_BUILD_DIR=str(tmp_path / "build"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["foreign"] == [] and out["blocked"] == [True, True]
    assert len(out["names"]) == 8 and "NativeVLMAdapter" in out["classes"]
    assert out["hf"] == "ModuleNotFoundError"  # only an HF adapter's model load needs it


def test_console_scripts_resolve_without_jax():
    """pyproject.toml names the port's four CLIs beside the JAX package's;
    each `module:function` resolves in a fresh interpreter without jax, and
    each parser is named after its script."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("videoitg-torch-")}
    assert port == {f"videoitg-torch-{cli}": f"videoitg_tpu_torch.cli.{mod}:main"
                    for cli, mod in (("select", "select"), ("eval", "evaluate"),
                                     ("train", "train"), ("serve", "serve"))}
    assert {k for k in scripts if not k.startswith("videoitg-torch-")} == {
        "videoitg-select", "videoitg-eval", "videoitg-train", "videoitg-serve"}
    code = (
        "import importlib, json, sys\n"
        f"port = {port!r}\n"
        "progs = {}\n"
        "for name, target in port.items():\n"
        "    mod, fn = target.split(':')\n"
        "    m = importlib.import_module(mod)\n"
        "    assert callable(getattr(m, fn))\n"
        "    progs[name] = m.build_parser().prog\n"
        "bad = ('jax', 'jaxlib', 'videoitg_tpu')\n"
        "foreign = sorted(k for k in sys.modules if k.split('.')[0] in bad)\n"
        "print(json.dumps({'foreign': foreign, 'progs': progs}))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["foreign"] == [] and out["progs"] == {k: k for k in port}


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


def test_parallel_modules_load_no_jax(tmp_path):
    """The multi-device slices' modules (videoitg_tpu_torch.parallel: the
    mesh, the sharding specs, tensor, ring and pipeline parallelism, the
    training step's gradients over the mesh),
    imported alone in a fresh interpreter with no compiler on the path:
    neither jax nor `videoitg_tpu` comes with them, the specs build, no
    process group is opened, and nothing is built."""
    mods = [m for m in _modules() if m.startswith("videoitg_tpu_torch.parallel")]
    assert {"videoitg_tpu_torch.parallel.mesh", "videoitg_tpu_torch.parallel.context",
            "videoitg_tpu_torch.parallel.sharding", "videoitg_tpu_torch.parallel.tensor",
            "videoitg_tpu_torch.parallel.ring_attention",
            "videoitg_tpu_torch.parallel.pipeline", "videoitg_tpu_torch.parallel.grads"
            } <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from videoitg_tpu_torch.parallel import mesh, sharding\n"
        "assert mesh.mesh_layout(8, pp=2) == (('pp', 'dp', 'tp'), (2, 1, 4))\n"
        "assert sharding.grounding_param_specs(pp=True)['lm']['layers']['q']['w'] == "
        "('pp', None, 'tp')\n"
        "import torch.distributed as dist\n"
        "from videoitg_tpu_torch.ops import _build\n"
        "foreign = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'videoitg_tpu'))\n"
        "print(json.dumps({'foreign': foreign, 'built': _build._lib is not None, "
        "'group': dist.is_initialized()}))\n")
    proc = _run(code, VIDEOITG_NVCC=str(tmp_path / "no-nvcc"), PATH="/usr/bin:/bin",
                VIDEOITG_TORCH_BUILD_DIR=str(tmp_path / "build"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"foreign": [], "built": False, "group": False}
    assert not (tmp_path / "build").exists()
