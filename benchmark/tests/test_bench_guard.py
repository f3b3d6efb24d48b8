"""The import guard, by whole top-level names, and the run's exits."""

import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark.guard import forbidden_modules
from benchmark.manifest import ROOT

from _tiny import run_tiny


def test_whole_top_level_names():
    assert forbidden_modules(["videoitg_tpu_torch", "videoitg_tpu_torch.engine",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["videoitg_tpu", "videoitg_tpu.engine", "jax", "jax.numpy",
                              "jaxlib.xla_client", "flax.linen", "numpy"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "videoitg_tpu",
        "videoitg_tpu.engine"]


@pytest.mark.parametrize("name", ["jax", "videoitg_tpu"])
def test_a_run_with_a_forbidden_module_loaded_fails(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(ImportError, match=name):
        run_tiny("itg8b.select512", seconds=0.05)


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); from _tiny import run_tiny; "
            "r = run_tiny('itg8b-act8.reuse12', seconds=0.05); "
            "from benchmark.guard import check_imports; print(check_imports(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "itg8b.select512",
                           "--seed", str(2 ** 31 + 7), "--seconds", "1", *extra], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_exits_without_a_result():
    out = _run(ROOT)
    if out.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert out.returncode == 3 and out.stdout == ""


def test_the_benchmark_alone_exits_without_a_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
