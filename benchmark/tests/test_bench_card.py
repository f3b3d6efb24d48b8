"""On the card, at a cell's own sizes: the program as configured passes its
cell's check, and the control (the configuration's "control": the
program's own path in the precision below, or the reference in it) fails
it; a whole run with a stale
answer or a wrong instruction planted in the timed path is not correct.
`pytest -m card benchmark/tests` on a machine with an NVIDIA GPU; skipped
without one."""

import gc
import os
import sys
import time

import pytest
import torch

from benchmark.check import gaps, pick_sample, reference_scores
from benchmark.harness import run_cell
from benchmark.inputs import make_traffic
from benchmark.manifest import ROOT, Manifest

sys.path.insert(0, os.path.join(ROOT, "benchmark", "tools"))

from test_bench_faults import PLANTED  # noqa: E402


@pytest.mark.card
@pytest.mark.parametrize("workload", ["itg8b.select512", "itg8b-act8.select512"])
def test_the_control_fails_and_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from readings import control_scores, program_scores

    seed = 2 ** 32 + 99
    man = Manifest()
    wl = man.workload(workload)
    cfg, mix = man.config(wl), man.mix(wl)
    device = torch.device("cuda:0")
    traffic = make_traffic(mix, seed, device)
    client = man.client(mix)
    sound = pick_sample(program_scores(cfg, mix, client, traffic, seed, device), seed,
                        **mix["check"])
    pairs = [(r.video, r.instruction) for r in sound]
    control = control_scores(cfg, mix, client, traffic, seed, device, pairs)
    gc.collect()
    torch.cuda.empty_cache()
    want = reference_scores(cfg, seed, traffic.videos, pairs, device)
    limits = cfg["check"]
    ok = gaps([r.scores for r in sound], want)
    bad = gaps(control, want)
    assert all(ok[k] <= v for k, v in limits.items()), ok
    assert any(bad[k] > v for k, v in limits.items()), bad


@pytest.mark.card
@pytest.mark.parametrize("workload,plant", PLANTED)
def test_a_planted_fault_is_not_correct_at_the_cells_size(monkeypatch, workload, plant):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    plant(monkeypatch)
    man = Manifest()
    wl = man.workload(workload)
    cfg, mix = man.config(wl), man.mix(wl)
    result = run_cell(cfg, mix, man.client(mix), man.readers(man.end_to_end(wl)),
                      2 ** 32 + 123, 6.0, False, torch.device("cuda:0"), time.perf_counter())
    assert result["correct"] is False and result["failed"] == 0, result["checks"]
    # each run checks as many requests as a benchmark run does
    assert result["attempted"] >= 2
