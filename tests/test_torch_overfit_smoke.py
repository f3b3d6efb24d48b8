"""scripts/train/torch_overfit_smoke.py at a size the CPU takes: preset tiny,
4 fixtures, 30 LoRA r4 steps with a checkpoint every 5. Phase 1 is killed
with SIGKILL right after its first checkpoint, phase 2 auto-resumes and
reaches the last step, the logged loss falls, and the last line carries a
Top-1 accuracy in [0, 1]. No accuracy threshold: 30 steps of a tiny model
do not learn the task; the card runs the 2B recipe (chip_smoke.py --only
overfit). The script's main runs in this process (its train CLI in child
processes, as always)."""

import importlib.util
import json
import os
import re
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "train", "torch_overfit_smoke.py")
STEPS = 30


def test_kill_resume_and_evaluate(tmp_path, capsys, monkeypatch):
    from videoitg_tpu_torch.data.video import write_test_video

    try:
        write_test_video(str(tmp_path / "probe.mp4"), 64, 48, 4, 10, 8)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the libav video reader cannot be built here: {e}")
    spec = importlib.util.spec_from_file_location("torch_overfit_smoke", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    # one thread a child: the children are small, and the test run's other
    # workers hold the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO)
    work = tmp_path / "work"
    rc = script.main(["--preset", "tiny", "--cpu", "--videos", "4", "--targets", "2",
                      "--steps", str(STEPS), "--save-steps", "5", "--lora", "4", "--lr", "2e-3",
                      "--kill-after", "0", "--threshold", "0", "--workdir", str(work)])
    out = capsys.readouterr().out
    assert rc == 0, out

    killed = int(re.search(r"SIGKILLed after checkpoint step (\d+)", out).group(1))
    phase1 = (work / "phase1.log").read_text()
    assert killed >= 5 and "[train] done at step" not in phase1  # killed mid-run
    phase2 = (work / "phase2.log").read_text()
    resumed = int(re.search(r"\[train\] auto-resumed from step (\d+)", phase2).group(1))
    assert resumed == killed
    assert f"[train] done at step {STEPS};" in phase2

    m = re.search(r"\[overfit\] loss (\S+) at step (\d+) -> (\S+) at step (\d+)", out)
    first, last = float(m.group(1)), float(m.group(3))
    assert int(m.group(4)) == STEPS and last < first

    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == {"top1_train_accuracy", "steps", "videos", "killed_at_step", "pass"}
    assert 0.0 <= res["top1_train_accuracy"] <= 1.0
    assert res["steps"] == STEPS and res["videos"] == 4 and res["killed_at_step"] == killed
