"""The port's tracer: spans and counters inside the program, and the
per-stage timer built on them.

A span is one named interval of one request: its host start and end on
`time.time_ns()`, the clock torch.profiler's own events are stamped on, so
spans and the profiler's kernels share one time base; its parent span; the
id of its request; counters (`args`: a `linear` span's operations and kind,
an `upload` span's bytes); and, on a CUDA device, its device time, from a
pair of CUDA events recorded at its two ends on the stream that was current
when its request opened. The
events come from a reused pool, and `elapsed_time` is resolved only when the
spans are read, after a synchronise: never on the hot path. On the CPU the
device time is absent (None).

Where spans open (the engine and the models):

    request                   the root, at the engine's public entries
      decode                  host only (select_from_file)
      preprocess
        upload                the host-to-device copy; args: bytes
      tower                   the vision tower, on every path
        linear  attention     linear args: ops = 2 M K N, kind bf16 | int8
      score                   one a question: projector, LM and head
        linear  attention

A request span opens at an engine entry unless one is already open in the
thread, and decides there whether the request is traced: while a
torch.profiler session records (or always, with VIDEOITG_TRACE=1, read once
at import), never under CUDA-graph stream capture. Its children follow that
decision. The stack of open spans is per thread, so a decode worker's
`preprocess_ahead` is a request of its own. With no traced request open a
span site costs one test of `tracing`: no event, no allocation, no stamp.

Finished requests are kept whole in a ring of MAX_REQUESTS, the oldest
dropped first, so a process left tracing does not grow. `read()` returns
their spans with the kernel wrappers' `.launches` counts beside them: it is
the exporter the benchmark's per-layer metrics use. One tracer serves the
process, as one profiler does.

`StageTimer` (the port's copy of the JAX package's) keeps per-stage host
time, and each stage is also a span: with tracing on, `summary()` adds the
stages' mean device ms.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

ENV_ON = os.environ.get("VIDEOITG_TRACE") == "1"
MAX_REQUESTS = 256

# True while a traced request is open in any thread: the one flag a span
# site tests before it does anything else.
tracing = False
NULL = contextlib.nullcontext()

_local = threading.local()
_lock = threading.Lock()
_open = 0
_ids = itertools.count(1)
_requests: collections.deque = collections.deque()  # finished requests' spans
_pool: Dict[int, collections.deque] = {}  # free CUDA events by device index

# The kernel wrappers' launch counters, read where their modules are loaded.
LAUNCH_COUNTERS = (
    ("videoitg_tpu_torch.ops.flash_attention", "flash_mha"),
    ("videoitg_tpu_torch.ops.flash_attention_short", "flash_mha_short"),
    ("videoitg_tpu_torch.ops.splash_attention", "splash_mqa"),
    ("videoitg_tpu_torch.ops.quant_gemm", "act8_gemm"),
    ("videoitg_tpu_torch.ops.fused_encoder", "fused_ln_qkv_int8"),
    ("videoitg_tpu_torch.ops.fused_encoder", "fused_ln_mlp_int8"),
    ("videoitg_tpu_torch.ops.fused_encoder", "fused_proj_residual_int8"),
    ("videoitg_tpu_torch.ops.layer_norm", "add_layer_norm"),
    ("videoitg_tpu_torch.ops.flash_attention_train", "flash_train_fwd"),
    ("videoitg_tpu_torch.ops.flash_attention_train", "flash_train_dq"),
    ("videoitg_tpu_torch.ops.flash_attention_train", "flash_train_dkv"),
    ("videoitg_tpu_torch.ops.flash_attention_segment", "flash_segment_fwd"),
    ("videoitg_tpu_torch.ops.flash_attention_segment", "flash_segment_dq"),
    ("videoitg_tpu_torch.ops.flash_attention_segment", "flash_segment_dkv"),
)


class Span:
    """One span; a context manager that closes it. `id` is its place in its
    request (the root is 0) and `parent` its parent's id (None at the root)."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "args",
                 "device_ms", "_device", "_stream", "_events", "_spans")

    def __init__(self, name: str, parent: Optional["Span"], stream, args: dict):
        self.name, self.args = name, args
        self.end_ns: Optional[int] = None
        self.device_ms: Optional[float] = None
        self._stream = stream
        if parent is None:
            self.id, self.parent, self.request = 0, None, next(_ids)
            self._spans = [self]
        else:
            self._spans = parent._spans
            self.id, self.parent, self.request = len(self._spans), parent.id, parent.request
            self._spans.append(self)
        self._events = None
        self.start_ns = time.time_ns()
        if stream is not None:
            self._device = stream.device_index
            self._events = (_event(self._device), _event(self._device))
            self._events[0].record(stream)
        _local.stack.append(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(self._stream)
        self.end_ns = time.time_ns()
        _local.stack.pop()
        if self.parent is None:
            _finish(self._spans)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, request={self.request}, id={self.id}, "
                f"parent={self.parent}, device_ms={self.device_ms}, args={self.args})")


class _Untraced:
    """An untraced request: marks the thread's request as open, so that the
    entries it calls do not decide again."""

    def __enter__(self) -> None:
        _stack().append(None)

    def __exit__(self, *exc) -> bool:
        _local.stack.pop()
        return False


_UNTRACED = _Untraced()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event(device: int):
    free = _pool.get(device)
    if free:
        try:
            return free.pop()
        except IndexError:
            pass
    return torch.cuda.Event(enable_timing=True)


def _release(spans: List[Span]) -> None:
    for s in spans:
        if s._events is not None:
            _pool.setdefault(s._device, collections.deque()).extend(s._events)
            s._events = None


def _finish(spans: List[Span]) -> None:
    global tracing, _open
    with _lock:
        _requests.append(spans)
        if len(_requests) > MAX_REQUESTS:
            _release(_requests.popleft())
        _open -= 1
        tracing = _open > 0


def _profiler_on() -> bool:
    from torch.autograd import profiler

    return bool(profiler._is_profiler_enabled)


def request(device: Optional[torch.device] = None):
    """The root span of a request on `device` (device times on a CUDA
    device), or a context that records nothing: where this thread already
    has a request open, or where the request is not traced."""
    global tracing, _open
    if _stack():
        return NULL
    if not (ENV_ON or _profiler_on()):
        return _UNTRACED
    stream = None
    if device is not None and torch.device(device).type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            return _UNTRACED
        stream = torch.cuda.current_stream(device)
    with _lock:
        _open += 1
        tracing = True
    return Span("request", None, stream, {})


def span(name: str, device: bool = True, **args):
    """A child of the innermost span open in this thread, with counters
    `args`; `device=False` for host-only work. A context that records
    nothing where this thread has no traced request open."""
    if not tracing:
        return NULL
    stack = getattr(_local, "stack", None)
    if not stack or stack[-1] is None:
        return NULL
    parent = stack[-1]
    return Span(name, parent, parent._stream if device else None, args)


def _resolve(spans: List[Span]) -> None:
    """Device ms of every span that has its events; they go back to the
    pool. Call under `_lock`."""
    timed = [s for s in spans if s._events is not None]
    for index in {s._device for s in timed}:
        torch.cuda.synchronize(index)
    for s in timed:
        s.device_ms = s._events[0].elapsed_time(s._events[1])
    _release(timed)


class Trace(NamedTuple):
    spans: List[Span]  # finished requests, oldest first, each root first
    launches: Dict[str, int]  # the kernel wrappers' `.launches`


def launches() -> Dict[str, int]:
    """Each loaded kernel wrapper's launch count."""
    out = {}
    for module, name in LAUNCH_COUNTERS:
        mod = sys.modules.get(module)
        if mod is not None:
            out[name] = getattr(mod, name).launches
    return out


def read() -> Trace:
    """The spans of the finished requests the ring holds, device times
    resolved (after a synchronise of each device they ran on)."""
    with _lock:
        spans = [s for req in _requests for s in req]
        _resolve(spans)
    return Trace(spans, launches())


def clear() -> None:
    """Drop every finished request."""
    with _lock:
        while _requests:
            _release(_requests.popleft())


def self_ms(spans: List[Span], parent: Span) -> Optional[float]:
    """A span's device ms less its children's: its self time."""
    if parent.device_ms is None:
        return None
    return parent.device_ms - sum(s.device_ms or 0.0 for s in spans
                                  if s.request == parent.request and s.parent == parent.id)


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design
    (one per pipeline worker). Each stage is also a span of the request it
    runs in; with tracing on, `summary()` adds `device_ms`, the mean device
    ms of the stage over its last traced spans."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.spans: collections.deque = collections.deque(maxlen=1024)

    @contextlib.contextmanager
    def stage(self, name: str, device: bool = True) -> Iterator[None]:
        sp = span(name, device=device) if tracing else NULL
        t0 = time.perf_counter()
        try:
            with sp:
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            if sp is not NULL:
                self.spans.append(sp)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(1, self.counts[name]), 2),
            }
            for name in sorted(self.totals)
        }
        traced = list(self.spans)
        if traced:
            with _lock:
                _resolve(traced)
            device: Dict[str, List[float]] = defaultdict(list)
            for s in traced:
                if s.device_ms is not None:
                    device[s.name].append(s.device_ms)
            for name, ms in device.items():
                out[name]["device_ms"] = round(sum(ms) / len(ms), 2)
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)
