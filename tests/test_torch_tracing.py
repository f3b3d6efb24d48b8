"""The port's tracer (videoitg_tpu_torch/utils/profiling.py) and its spans
in the engine, on the CPU: nesting, parents and request ids, per-thread
stacks, the bounded buffer, self time, on and off; one root per request
with its stages; the linear operations counted against 2 M K N worked out
from the config; the stage timer's keys."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videoitg_tpu_torch.config import preset
from videoitg_tpu_torch.engine import SelectionEngine
from videoitg_tpu_torch.models.grounding import init_grounding
from videoitg_tpu_torch.ops.quant import apply_quantization_tier
from videoitg_tpu_torch.utils import profiling
from videoitg_tpu_torch.utils.common import CharTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = preset("tiny")
T = 8  # frames, one whole bucket


@pytest.fixture(autouse=True)
def empty_tracer():
    profiling.clear()
    yield
    profiling.clear()


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _engine(tier=None, kernels=False):
    model = init_grounding(CFG, torch.Generator().manual_seed(0))
    if tier:
        apply_quantization_tier(model, tier)
    return SelectionEngine(model, CFG, CharTokenizer(CFG.lm.vocab_size), device="cpu",
                           dtype=torch.float32, buckets=(4, T), num_frames=T,
                           use_flash=kernels, qgemm=kernels, fused=kernels)


def _frames(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (T, 56, 56, 3), dtype=np.uint8)


def _tree(spans, request):
    """{id: (name, parent name)} of one request's spans."""
    mine = {s.id: s for s in spans if s.request == request}
    return {i: (s.name, mine[s.parent].name if s.parent is not None else None)
            for i, s in mine.items()}


def _stages(spans, request):
    """Names of a request's root's children, in order."""
    return [s.name for s in spans if s.request == request and s.parent == 0]


def test_spans_nest_under_one_request_id():
    with _profiler():
        with profiling.request():
            with profiling.span("tower"):
                with profiling.span("linear", ops=12.0, kind="bf16"):
                    pass
                with profiling.span("attention"):
                    pass
            with profiling.span("decode", device=False):
                pass
        with profiling.request():
            pass
    spans = profiling.read().spans
    first, second = spans[0].request, spans[-1].request
    assert first != second and [s.request for s in spans] == [first] * 5 + [second]
    assert _tree(spans, first) == {0: ("request", None), 1: ("tower", "request"),
                                   2: ("linear", "tower"), 3: ("attention", "tower"),
                                   4: ("decode", "request")}
    assert spans[2].args == {"ops": 12.0, "kind": "bf16"}
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None  # no device on the CPU
    root, tower, linear = spans[:3]
    assert root.start_ns <= tower.start_ns <= linear.start_ns <= linear.end_ns <= tower.end_ns
    assert tower.end_ns <= root.end_ns


def test_an_entry_inside_a_request_opens_no_second_root():
    with _profiler():
        with profiling.request():
            assert profiling.request() is profiling.NULL
            with profiling.span("score"):
                pass
    assert [s.name for s in profiling.read().spans] == ["request", "score"]


def test_off_records_no_span_and_no_event(monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("an event was made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    engine = _engine()
    assert not profiling.tracing
    with profiling.request():
        assert profiling.span("tower") is profiling.NULL
    engine.select(_frames(), list(range(T)), "what happens?")
    assert profiling.read().spans == [] and not profiling.tracing


def test_on_only_while_a_profiler_records():
    engine = _engine()
    engine.select(_frames(), list(range(T)), "before")
    with _profiler():
        engine.select(_frames(), list(range(T)), "during")
    engine.select(_frames(), list(range(T)), "after")
    roots = [s for s in profiling.read().spans if s.name == "request"]
    assert len(roots) == 1 and not profiling.tracing


def test_the_environment_switch_is_read_at_import(monkeypatch):
    code = "from videoitg_tpu_torch.utils import profiling; print(profiling.ENV_ON)"
    env = dict(os.environ, PYTHONPATH=REPO, VIDEOITG_TRACE="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "True"
    monkeypatch.setattr(profiling, "ENV_ON", True)
    with profiling.request():
        with profiling.span("score"):
            pass
    assert [s.name for s in profiling.read().spans] == ["request", "score"]


def test_each_thread_has_its_own_stack():
    both_open = threading.Barrier(2, timeout=30)

    def worker(name):
        with profiling.request():
            with profiling.span(name):
                both_open.wait()
                with profiling.span("linear", ops=1.0, kind="bf16"):
                    pass

    with _profiler():
        threads = [threading.Thread(target=worker, args=(n,)) for n in ("tower", "score")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans = profiling.read().spans
    requests = {s.request for s in spans}
    assert len(requests) == 2
    trees = sorted(tuple(sorted(_tree(spans, r).values(), key=str)) for r in requests)
    assert trees == sorted([
        tuple(sorted([("request", None), (n, "request"), ("linear", n)], key=str))
        for n in ("tower", "score")])


def test_the_buffer_keeps_the_newest_whole_requests(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_REQUESTS", 3)
    with _profiler():
        for i in range(5):
            with profiling.request():
                for _ in range(i + 1):
                    with profiling.span("linear", ops=1.0, kind="bf16"):
                        pass
    spans = profiling.read().spans
    roots = [s for s in spans if s.name == "request"]
    assert len(roots) == 3 and len(spans) == 3 + 3 + 4 + 5
    assert [s.request for s in roots] == sorted(s.request for s in roots)


def test_self_time_is_the_parent_less_its_children():
    with _profiler():
        with profiling.request():
            with profiling.span("tower"):
                for _ in range(2):
                    with profiling.span("linear", ops=1.0, kind="bf16"):
                        pass
                with profiling.span("attention"):
                    pass
    spans = profiling.read().spans
    for s, ms in zip(spans, (10.0, 9.0, 2.0, 3.0, 1.5)):
        s.device_ms = ms
    assert profiling.self_ms(spans, spans[1]) == pytest.approx(9.0 - 2.0 - 3.0 - 1.5)
    assert profiling.self_ms(spans, spans[0]) == pytest.approx(1.0)
    assert profiling.self_ms(spans, spans[2]) == pytest.approx(2.0)  # no children


def test_select_is_one_request_with_its_stages():
    engine = _engine()
    with _profiler():
        engine.select(_frames(), list(range(T)), "what happens next?")
    spans = profiling.read().spans
    (req,) = {s.request for s in spans}
    assert _stages(spans, req) == ["preprocess", "tower", "score"]
    tree = _tree(spans, req)
    assert ("upload", "preprocess") in tree.values()
    parents = {s.name: set() for s in spans}
    for name, parent in tree.values():
        parents[name].add(parent)
    # every product and attention call sits directly under a stage
    assert parents["linear"] == parents["attention"] == {"tower", "score"}
    (upload,) = [s for s in spans if s.name == "upload"]
    assert upload.args == {"bytes": T * 56 * 56 * 3}


def test_encode_then_questions_and_a_video_from_another_thread():
    engine = _engine()
    frames = _frames()
    with _profiler():
        enc = engine.encode_video(frames)
        engine.score_encoded(enc, ["first?", "second?", "third?"])
        box = {}
        worker = threading.Thread(target=lambda: box.update(v=engine.preprocess_ahead(frames)))
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
        engine.select(box["v"], list(range(T)), "from the worker")
    spans = profiling.read().spans
    reqs = sorted({s.request for s in spans})
    assert len(reqs) == 4
    assert _stages(spans, reqs[0]) == ["preprocess", "tower"]
    assert _stages(spans, reqs[1]) == ["score"] * 3
    assert _stages(spans, reqs[2]) == ["preprocess"]  # the worker's own request
    assert ("upload", "preprocess") in _tree(spans, reqs[2]).values()
    assert _stages(spans, reqs[3]) == ["preprocess", "tower", "score"]
    assert ("upload", "preprocess") not in _tree(spans, reqs[3]).values()
    # the projector runs once, in the first question's span
    first, second = [s for s in spans if s.request == reqs[1] and s.name == "score"][:2]
    n_lin = [sum(1 for s in spans if s.request == reqs[1] and s.parent == q.id
                 and s.name == "linear") for q in (first, second)]
    assert n_lin[0] == n_lin[1] + 2


def _expected_ops(tier):
    """(tower, score) operations of one select of T frames by kind, worked
    out from the config: every product over every slot the program runs,
    the max_text_len text slots included."""
    v, p, lm = CFG.vision, CFG.projector, CFG.lm
    tokens = T * v.num_patches
    layers = v.num_effective_layers
    patch = 2 * tokens * v.patch_size ** 2 * 3 * v.hidden_size
    h, m = v.hidden_size, v.intermediate_size
    encoder = layers * 2 * tokens * (4 * h * h + 2 * h * m)
    hw = CFG.projector.tokens_hw(T, v.num_patches_per_side)
    img = T * hw * hw
    s = img + CFG.max_text_len
    q_dim, kv_dim = lm.num_heads * lm.head_dim, lm.num_kv_heads * lm.head_dim
    proj = 2 * img * p.input_dim * p.output_dim + 2 * img * p.output_dim * p.output_dim
    dec = lm.num_layers * 2 * s * (lm.hidden_size * (q_dim + 2 * kv_dim) + q_dim * lm.hidden_size
                                   + 3 * lm.hidden_size * lm.intermediate_size)
    head = 2 * T * lm.hidden_size
    if tier == "act8":
        return {"bf16": patch, "int8": encoder}, {"bf16": proj + head, "int8": dec}
    return {"bf16": patch + encoder}, {"bf16": proj + dec + head}


@pytest.mark.parametrize("tier, kernels", [(None, False), ("act8", False), ("act8", True)],
                         ids=["bf16", "act8-library", "act8-kernels"])
def test_linear_operations_are_2mkn_from_the_config(tier, kernels):
    engine = _engine(tier, kernels)
    with _profiler():
        engine.select(_frames(), list(range(T)), "count the work")
    spans = profiling.read().spans
    by_id = {s.id: s for s in spans}
    got = {"tower": {}, "score": {}}
    for s in spans:
        if s.name == "linear":
            stage = got[by_id[s.parent].name]
            stage[s.args["kind"]] = stage.get(s.args["kind"], 0.0) + s.args["ops"]
    tower, score = _expected_ops("act8" if tier else None)
    assert got["tower"] == pytest.approx(tower, rel=1e-12)
    assert got["score"] == pytest.approx(score, rel=1e-12)
    n_fused = sum(1 for s in spans if s.name == "linear" and by_id[s.parent].name == "tower")
    layers = CFG.vision.num_effective_layers
    assert n_fused == 1 + layers * (3 if kernels else 4)


def test_stage_timer_keys_stay_with_tracing_off():
    engine = _engine()
    engine.select(_frames(), list(range(T)), "what happens?")
    enc = engine.encode_video(_frames())
    engine.score_encoded(enc, ["one", "two"])
    summary = engine.timer.summary()
    assert list(summary) == ["preprocess", "score", "tower"]
    assert all(set(v) == {"total_s", "count", "mean_ms"} for v in summary.values())
    assert (summary["tower"]["count"], summary["score"]["count"]) == (2, 3)


def test_stage_timer_adds_device_ms_from_its_spans():
    engine = _engine()
    with _profiler():
        engine.select(_frames(), list(range(T)), "what happens?")
        engine.select(_frames(), list(range(T)), "and then?")
    assert set(engine.timer.summary()["tower"]) == {"total_s", "count", "mean_ms"}  # CPU
    for i, s in enumerate(engine.timer.spans):
        s.device_ms = 2.0 + (i % 3)  # preprocess, tower, score: 2, 3, 4 ms
    summary = engine.timer.summary()
    assert {k: v["device_ms"] for k, v in summary.items()} == {
        "preprocess": 2.0, "tower": 3.0, "score": 4.0}
    assert summary["score"]["count"] == 2
