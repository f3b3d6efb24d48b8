"""The port's launchers (scripts/torch_recipes/*.sh, scripts/torch_eval/*.sh,
scripts/train/torch_finetune-grounding.sh) against their JAX originals.

Each passes `bash -n`. Each then runs under bash with stub executables first
on PATH (`videoitg-torch-train`, `videoitg-torch-eval`, `torchrun` and the
JAX package's `videoitg-train`, `videoitg-eval`) that record their arguments,
so nothing real runs and bash fills in the environment's defaults. A launcher
invokes only `videoitg-torch-*` or `torchrun ... -m videoitg_tpu_torch.cli.*`;
every call's flags parse with its CLI's own `build_parser()`; and the calls
carry the original's flags, one for one, except the named difference: stage 1
and stage 4 with DP x TP > 1 run under `torchrun --nproc-per-node DP*TP` with
`--dp DP --tp TP` first.
"""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHERS = {  # the port's launcher -> its JAX original
    "scripts/torch_recipes/stage1_pretrain_projector.sh":
        "scripts/recipes/stage1_pretrain_projector.sh",
    "scripts/torch_recipes/stage2_sft_image.sh": "scripts/recipes/stage2_sft_image.sh",
    "scripts/torch_recipes/stage3_sft_video.sh": "scripts/recipes/stage3_sft_video.sh",
    "scripts/torch_recipes/stage4_grounding_finetune.sh":
        "scripts/recipes/stage4_grounding_finetune.sh",
    "scripts/torch_eval/videomme_grounding.sh": "scripts/eval/videomme_grounding.sh",
    "scripts/torch_eval/downstream_internvl.sh": "scripts/eval/downstream_internvl.sh",
    "scripts/torch_eval/downstream_eagle2_5.sh": "scripts/eval/downstream_eagle2_5.sh",
    "scripts/torch_eval/downstream_llava_video.sh": "scripts/eval/downstream_llava_video.sh",
    "scripts/torch_eval/downstream_qwen3vl.sh": "scripts/eval/downstream_qwen3vl.sh",
    "scripts/train/torch_finetune-grounding.sh": "scripts/train/finetune-grounding.sh",
}
MESH_LAUNCHERS = ("scripts/torch_recipes/stage1_pretrain_projector.sh",
                  "scripts/torch_recipes/stage4_grounding_finetune.sh")
PORT_CLIS = {"videoitg-torch-train": "train", "videoitg-torch-eval": "evaluate"}
JAX_CLIS = {"videoitg-train": "train", "videoitg-eval": "evaluate"}
STUB = """#!/bin/bash
{ printf '%s' "$(basename "$0")"; for a in "$@"; do printf '\\t%s' "$a"; done; printf '\\n'; } \\
    >> "$STUB_LOG"
"""


@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stubs")
    for name in (*PORT_CLIS, *JAX_CLIS, "torchrun"):
        (d / name).write_text(STUB)
        (d / name).chmod(0o755)
    return d


def calls(script, stubs, tmp_path, **env):
    """[[command, args...] of each stub call] of `bash script`."""
    log = tmp_path / f"{os.path.basename(script)}.{len(os.listdir(tmp_path))}.calls"
    run_env = {"PATH": f"{stubs}:/usr/bin:/bin", "STUB_LOG": str(log), "HF_HOME": "/hf",
               "HOME": str(tmp_path), **env}
    proc = subprocess.run(["bash", os.path.join(REPO, script)], cwd=tmp_path, env=run_env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return [line.split("\t") for line in log.read_text().splitlines()]


def port_cli(call):
    """(CLI module name, its argv) of one of the port's calls."""
    name, args = call[0], call[1:]
    if name == "torchrun":
        assert args[:1] == ["--nproc-per-node"] and args[2] == "-m", call
        module = args[3]
        assert module.startswith("videoitg_tpu_torch.cli."), call
        return module.rsplit(".", 1)[1], args[4:]
    assert name in PORT_CLIS, f"{name} is not one of the port's console scripts"
    return PORT_CLIS[name], args


def parses(cli, argv):
    from videoitg_tpu_torch.cli import evaluate, train

    parser = {"train": train, "evaluate": evaluate}[cli].build_parser()
    parser.parse_args(argv)  # SystemExit on a flag it does not know


@pytest.mark.parametrize("script", list(LAUNCHERS))
def test_bash_syntax(script):
    proc = subprocess.run(["bash", "-n", os.path.join(REPO, script)], capture_output=True,
                          text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("script", list(LAUNCHERS))
def test_same_flags_as_the_original(script, stubs, tmp_path):
    mine = calls(script, stubs, tmp_path)
    theirs = calls(LAUNCHERS[script], stubs, tmp_path)
    assert mine and len(mine) == len(theirs)
    for call, original in zip(mine, theirs):
        cli, argv = port_cli(call)
        assert call[0] != "torchrun"  # one process without a mesh
        assert JAX_CLIS[original[0]] == cli
        parses(cli, argv)
        assert argv == original[1:]


@pytest.mark.parametrize("script", MESH_LAUNCHERS)
def test_mesh_runs_under_torchrun(script, stubs, tmp_path):
    """DP x TP > 1: one torchrun process a device, the axes on the CLI."""
    (call,) = calls(script, stubs, tmp_path, DP="2", TP="2")
    (original,) = calls(LAUNCHERS[script], stubs, tmp_path, DP="2", TP="2")
    assert call[:5] == ["torchrun", "--nproc-per-node", "4", "-m", "videoitg_tpu_torch.cli.train"]
    cli, argv = port_cli(call)
    parses(cli, argv)
    assert argv == ["--dp", "2", "--tp", "2"] + original[1:]
    (single,) = calls(script, stubs, tmp_path, DP="1", TP="1")
    assert single[0] == "videoitg-torch-train" and single[1:] == original[1:]
