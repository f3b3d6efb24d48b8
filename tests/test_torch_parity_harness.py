"""The port's real-checkpoint parity harness (scripts/torch_parity_vs_hf.py)
passes end to end on synthesized full-layout checkpoints, as
tests/test_parity_harness.py holds the JAX one: tiny, and VideoITG-8B's
widths at CI size (4 frames, seq_mlp budget 512). The port runs on the CPU
here, and the script loads neither jax nor the JAX package."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _harness():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import torch_parity_vs_hf
    finally:
        sys.path.pop(0)
    return torch_parity_vs_hf


def test_selftest_tiny(tmp_path):
    report = _harness().selftest(str(tmp_path), device="cpu")
    assert report["pass"] and report["scores_2dp_equal"]
    assert report["top3_index_equal"] and report["top8_index_equal"]
    assert report["max_abs_score_diff"] < 1e-4
    assert (tmp_path / "parity.json").exists()


def test_selftest_8b_geometry(tmp_path):
    reports = _harness().selftest_8b(str(tmp_path), frames=4, budget=512, flash_budget=256,
                                     device="cpu")
    for arm in ("oracle", "flash"):
        assert reports[arm]["pass"], arm
        assert reports[arm]["max_abs_score_diff"] < 1e-4, arm


def test_script_runs_without_jax(tmp_path):
    code = ("import runpy, sys\n"
            "sys.argv = ['torch_parity_vs_hf.py', '--selftest', '--cpu']\n"
            "try:\n"
            "    runpy.run_path(%r, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'videoitg_tpu'))\n"
            "print('FOREIGN', bad)\n") % os.path.join(REPO, "scripts", "torch_parity_vs_hf.py")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert "[parity] selftest PASS" in proc.stdout and "FOREIGN []" in proc.stdout
