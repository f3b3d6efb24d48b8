#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on this machine's card.

    python3 benchmark/run.py --workload itg8b.select512 --seed 7 --seconds 45 --trace 0

From the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error. With no CUDA device
(or fewer than the cell asks for) it exits 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache at a fixed path inside the checkout.
os.environ["VIDEOITG_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build", "videoitg_tpu_torch")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
# Libraries that would load JAX or Flax by themselves stay off.
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
