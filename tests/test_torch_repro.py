"""Kernels L: the plain versions of `double_literal` / `double_no_literal`
against the two Pallas kernels of scripts/repro_pallas_interpret_vma.py, run
in interpret mode through the script's own `call_kernel` OUTSIDE any
`shard_map` (inside one they fail, which is what the script reproduces; its
`main` is not run here). Bit-equal: x * 2 and x + x are the same fp32 value.
The CUDA kernels run on the card only (chip_smoke.py,
scripts/torch_repro_kernels.py)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from videoitg_tpu_torch.ops import repro_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def original():
    spec = importlib.util.spec_from_file_location(
        "repro_pallas_interpret_vma",
        os.path.join(REPO, "scripts", "repro_pallas_interpret_vma.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    x[0, :6] = [0.0, -0.0, np.inf, -np.inf, np.finfo(np.float32).max, 1e-30]
    return x


@pytest.mark.parametrize("name,kernel", [("double_literal", "kernel_literal"),
                                         ("double_no_literal", "kernel_no_literal")])
def test_plain_versions_equal_the_pallas_kernels(original, name, kernel):
    x = _inputs()
    want = np.asarray(original.call_kernel(getattr(original, kernel), jnp.asarray(x)))
    wrapper = getattr(repro_kernels, name)
    plain = getattr(repro_kernels, name + "_reference")
    before = wrapper.launches
    got = wrapper(torch.from_numpy(x))  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == (8, 128)
    assert torch.equal(got, plain(torch.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert wrapper.launches == before


def test_the_two_kernels_are_one_function():
    x = torch.from_numpy(_inputs())
    a, b = repro_kernels.double_literal(x), repro_kernels.double_no_literal(x)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.isinf(a[0, 4]) and a[0, 5] == 2 * x[0, 5]


def test_the_script_imports_nothing_of_jax():
    import subprocess
    import sys

    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('s', 'scripts/torch_repro_kernels.py')\n"
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
            "rc = m.main()\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'videoitg_tpu')]\n"
            "print(rc, bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    rc, bad = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert bad == "[]"
    if not torch.cuda.is_available():
        assert rc == "2" and "no CUDA device" in proc.stderr  # it needs the card and says so
