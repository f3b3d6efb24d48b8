"""One run of one cell: set-up, the measured window, the traced window's
reduction, the check against the reference, and the result line.

`run_cell` takes the device and the cell's files as arguments, so a test
drives a whole run on the CPU at a small size; `main` is the command line,
which looks for the card first.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

import torch

from benchmark import clocks, guard
from benchmark.check import check, gaps, pick_sample
from benchmark.inputs import derive, make_traffic
from benchmark.manifest import Manifest, reference_module
from benchmark.port import DTYPES, LM_ATTENTION, Calls, build_engine, install_ranges
from benchmark.requests import Request
from benchmark.weights import make_weights


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Run:
    """What the metric readers (benchmark/metrics/*.py) read."""

    cfg: dict
    mix: dict
    requests: List[Request]  # completed in the window
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: Optional[object] = None  # trace.TraceSummary
    calls: Optional[Calls] = None
    arch: Optional[ModuleType] = None  # the configuration's architecture module


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(client, seconds: float) -> tuple:
    """Closed loop: issue a request, wait for its scores, issue the next. The
    window ends when the first request that completes at or after `seconds`
    completes. Returns (completed, attempted, failed, window_s)."""
    done: List[Request] = []
    attempted = failed = 0
    t0 = time.perf_counter()
    t_end = t0
    while True:
        attempted += 1
        t_issue = time.perf_counter()
        try:
            req = client.next()
        except Exception as e:  # a request that fails counts, and the window goes on
            failed += 1
            log(f"request {attempted} failed: {e!r}")
            req = None
        t_end = time.perf_counter()
        if req is not None:
            req.t_issue, req.t_done = t_issue - t0, t_end - t0
            done.append(req)
        if t_end - t0 >= seconds:
            break
    return done, attempted, failed, t_end - t0


def run_cell(cfg: dict, mix: dict, client_cls, readers: Dict[str, tuple], seed: int,
             seconds: float, trace: bool, device, t_start: float,
             arch: Optional[ModuleType] = None) -> dict:
    """`arch` is the configuration's architecture module (by default the one
    its "reference" names in this checkout): its weights, its work count,
    its LM attention range and the reference that decides `correct`."""
    arch = reference_module(cfg) if arch is None else arch
    dtype = DTYPES[cfg["dtype"]]
    marks = [("start", time.perf_counter())]
    traffic = make_traffic(mix, seed, device)
    marks.append(("traffic", time.perf_counter()))
    state = make_weights(cfg["model"], derive(seed, "weights"), device, dtype, arch)
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    engine = build_engine(cfg, state, device)
    del state
    _sync(device)
    marks.append(("model", time.perf_counter()))
    client = client_cls(engine, traffic)
    client.warm()
    _sync(device)
    marks.append(("warm", time.perf_counter()))
    log(f"set-up: imports and device {marks[0][1] - t_start:.3f} s, " + ", ".join(
        f"{name} {t - marks[i][1]:.3f} s" for i, (name, t) in enumerate(marks[1:])))
    calls = restore = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        calls = Calls()
        restore = install_ranges(calls, getattr(arch, "LM_ATTENTION", LM_ATTENTION))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    if device.type == "cuda":
        log(f"clocks before the window: {clocks.sample()}")
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    if trace:
        with record_function("bench:window"):
            done, attempted, failed, window_s = window(client, seconds)
    else:
        done, attempted, failed, window_s = window(client, seconds)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        log(f"clocks after the window: {clocks.sample()}")
    summary = None
    if trace:
        from benchmark.trace import from_profiler, summarize

        prof.__exit__(None, None, None)
        restore()
        summary = summarize(*from_profiler(prof))
        del prof
        log(f"trace: window {summary.window_s:.4f} s, busy {summary.busy_s:.4f} s, "
            f"unlinked device time {summary.unlinked_s:.6f} s, ranges {summary.counts}")
    lat = sorted(r.latency_s for r in done)
    log(f"window {window_s:.4f} s: {len(done)} completed of {attempted}, {failed} failed; "
        f"latency min {lat[0] if lat else 0:.4f} median {lat[len(lat) // 2] if lat else 0:.4f} "
        f"max {lat[-1] if lat else 0:.4f} s; setup {setup_s:.4f} s; peak {peak} bytes")

    run = Run(cfg, mix, done, window_s, setup_s, peak, summary, calls, arch)
    metrics = {}
    for name, (reader, unit) in readers.items():
        value = reader.read(run) if done else None
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}

    # The sample's scores are on the host; the program's state goes before
    # the reference runs, so that the reference neither meets it nor sets
    # the process's peak.
    sample = pick_sample(done, seed, **mix["check"]) if done else []
    del client, engine, done, run, calls
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = guard.check_imports()
    if found:
        raise ImportError(f"forbidden modules loaded: {found}")
    limits = cfg["check"]
    numbers = (check(cfg, seed, traffic.videos, sample, device, log, arch) if sample
               else gaps([], []))
    correct = bool(sample) and failed == 0 and all(numbers[k] <= v for k, v in limits.items())
    # A missing or non-finite score reads null: JSON has no infinity.
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None, "limit": v}
              for k, v in limits.items()}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    result["device"] = dev
    if summary is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result["checks"] = checks
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    man = Manifest()
    wl = man.workload(args.workload)
    cfg, mix = man.config(wl), man.mix(wl)
    client_cls = man.client(mix)
    metrics = man.per_layer(wl) if args.trace else man.end_to_end(wl)
    readers = man.readers(metrics)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        log(f"needs {wl['chips']} CUDA device(s): torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda:0")
    log(f"{args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace} "
        f"on {torch.cuda.get_device_name(device)}, torch {torch.__version__}")
    result = run_cell(cfg, mix, client_cls, readers, args.seed, args.seconds, bool(args.trace),
                      device, t_start, man.reference(cfg))
    found = guard.check_imports()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 4
    emit(result)
    return 0
