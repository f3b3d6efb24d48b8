"""The per-layer metrics that read the program's own spans
(benchmark/program_spans.py): their arithmetic on synthetic spans, None
where they cannot read (counts that disagree with the window's requests,
no device time, a program with no tracer), shares that reach 100% only at
the least time, and the program's counted linear work against
`roofline.request_work` at the tiny sizes."""

from types import SimpleNamespace

import pytest
import torch

from _tiny import run_tiny, tiny_cell
from benchmark import program_spans
from benchmark.inputs import derive, make_traffic
from benchmark.manifest import Manifest
from benchmark.port import DTYPES, build_engine
from benchmark.requests import Request
from benchmark.roofline import PEAK_BF16, PEAK_INT8, linear_ops, request_work
from benchmark.weights import make_weights

NEW = ["tower_linear_roofline", "tower_rest_ms", "score_linear_roofline", "score_rest_ms",
       "upload_gbps"]


def _readers():
    man = Manifest()
    return {m["name"]: r for m in man.spec["per_layer"] if m["name"] in NEW
            for r, _ in man.readers([m]).values()}


def _span(request, id, parent, name, ms, **args):
    return SimpleNamespace(request=request, id=id, parent=parent, name=name, device_ms=ms,
                           args=args)


def _select(request, tower_ms, linear_ms, least_ms, kind="bf16", upload=(2e7, 4.0)):
    """One request's spans: preprocess (upload), tower (a linear taking
    `linear_ms` for work of least time `least_ms`, attention 30 ms), score
    (a linear of half that, attention 20 ms)."""
    peak = PEAK_INT8 if kind == "int8" else PEAK_BF16
    return [_span(request, 0, None, "request", None),
            _span(request, 1, 0, "preprocess", 5.0),
            _span(request, 2, 1, "upload", upload[1], bytes=upload[0]),
            _span(request, 3, 0, "tower", tower_ms),
            _span(request, 4, 3, "linear", linear_ms, ops=least_ms / 1e3 * peak, kind=kind),
            _span(request, 5, 3, "attention", 30.0),
            _span(request, 6, 0, "score", 50.0),
            _span(request, 7, 6, "linear", linear_ms / 2, ops=least_ms / 2e3 * peak, kind=kind),
            _span(request, 8, 6, "attention", 20.0)]


def _run(n):
    reqs = [Request(video=0, group=i, instruction="q", frames=512, questions=1, encoded=True)
            for i in range(n)]
    return SimpleNamespace(trace=object(), requests=reqs)


def test_arithmetic_on_synthetic_spans(monkeypatch):
    spans = (_select(1, 100.0, 40.0, 20.0)
             + _select(2, 120.0, 40.0, 10.0, kind="int8", upload=(3e7, 6.0)))
    monkeypatch.setattr(program_spans, "read_program", lambda: spans)
    got = {name: r.read(_run(2)) for name, r in _readers().items()}
    assert got == pytest.approx({
        "tower_linear_roofline": 100.0 * (20 + 10) / (40 + 40),
        "tower_rest_ms": ((100 - 40 - 30) + (120 - 40 - 30)) / 2,
        "score_linear_roofline": 100.0 * (10 + 5) / (20 + 20),
        "score_rest_ms": 50.0 - 20.0 - 20.0,
        "upload_gbps": (2e7 + 3e7) / 0.010 / 1e9,
    })


@pytest.mark.parametrize("change", ["a question more", "an encoded request more",
                                    "no device time", "no tracer", "untraced"])
def test_none_where_the_spans_cannot_be_read(monkeypatch, change):
    spans = _select(1, 100.0, 40.0, 20.0)
    run = _run(1)
    if change == "a question more":
        run.requests[0].questions = 2
    elif change == "an encoded request more":
        run.requests.append(Request(video=0, group=1, instruction="q", frames=512,
                                    questions=0, encoded=True))
    elif change == "no device time":
        for s in spans:
            s.device_ms = None
    elif change == "untraced":
        run.trace = None
    if change == "no tracer":
        from videoitg_tpu_torch.utils import profiling

        monkeypatch.delattr(profiling, "read")
    else:
        monkeypatch.setattr(program_spans, "read_program", lambda: spans)
    assert {name: r.read(run) for name, r in _readers().items()} == dict.fromkeys(NEW)


def test_a_share_reaches_100_only_at_the_least_time(monkeypatch):
    readers = _readers()
    for linear_ms, least_ms in ((20.0, 20.0), (40.0, 20.0), (1000.0, 1.0)):
        for kind in ("bf16", "int8"):
            spans = _select(1, 100.0 + linear_ms, linear_ms, least_ms, kind=kind)
            monkeypatch.setattr(program_spans, "read_program", lambda: spans)
            for name in ("tower_linear_roofline", "score_linear_roofline"):
                share = readers[name].read(_run(1))
                assert share == pytest.approx(100.0 * least_ms / linear_ms)
                assert share <= 100.0 + 1e-9


def test_the_traced_cpu_run_records_spans_but_reads_no_device_metric():
    from videoitg_tpu_torch.utils import profiling

    profiling.clear()
    result = run_tiny("itg8b.select512", seconds=0.2, trace=True)
    assert not set(NEW) & set(result["metrics"])
    spans = profiling.read().spans
    assert {"request", "preprocess", "upload", "tower", "score", "linear",
            "attention"} <= {s.name for s in spans}
    assert all(s.device_ms is None for s in spans)
    profiling.clear()


@pytest.mark.parametrize("workload", ["itg8b.select512", "itg8b-act8.select512"])
def test_the_programs_linear_work_is_the_benchmarks(workload):
    """One request of 32 frames (a whole bucket) at the tiny sizes: the
    program counts every one of the max_text_len text slots it runs, the
    benchmark's `request_work` the valid instruction tokens. Counted over
    max_text_len slots the two agree to rounding, kind by kind; the
    difference from the valid count is the LM linears over the padded slots."""
    from torch.profiler import ProfilerActivity, profile

    from videoitg_tpu_torch.utils import profiling

    man, wl, cfg, mix = tiny_cell(workload, frames=32)
    device, seed = torch.device("cpu"), 2 ** 31 + 5
    traffic = make_traffic(mix, seed, device)
    state = make_weights(cfg["model"], derive(seed, "weights"), device, DTYPES[cfg["dtype"]])
    client = man.client(mix)(build_engine(cfg, state, device), traffic)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        req = client.next()
    spans = profiling.read().spans
    profiling.clear()
    got = {"bf16": 0.0, "int8": 0.0}
    for s in spans:
        if s.name == "linear":
            got[s.args["kind"]] += s.args["ops"]
    model, tier = cfg["model"], cfg.get("tier")
    full = request_work(model, tier, req.frames, model["max_text_len"], with_tower=True)
    assert (got["bf16"], got["int8"]) == pytest.approx((full.bf16_ops, full.int8_ops),
                                                       rel=1e-12)
    valid = min(len(req.instruction) + 1, model["max_text_len"])
    assert valid < model["max_text_len"]
    lm = model["lm"]
    q_dim, kv_dim = lm["num_heads"] * lm["head_dim"], lm["num_kv_heads"] * lm["head_dim"]
    per_slot = lm["num_layers"] * (linear_ops(1, lm["hidden_size"], q_dim + 2 * kv_dim)
                                   + linear_ops(1, q_dim, lm["hidden_size"])
                                   + 3 * linear_ops(1, lm["hidden_size"],
                                                    lm["intermediate_size"]))
    bench = request_work(model, tier, req.frames, valid, with_tower=True)
    padded = (model["max_text_len"] - valid) * per_slot
    assert got["bf16"] + got["int8"] - (bench.bf16_ops + bench.int8_ops) == pytest.approx(
        padded, rel=1e-12)
