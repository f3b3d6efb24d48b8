"""The traced run: torch.profiler over the window, reduced in memory.

The benchmark's own ranges (`torch.profiler.record_function("bench:<name>")`,
installed from outside the program, see port.py) mark what the host was
doing. A device operation (kernel, copy or fill) belongs to every range
that was open on the host when it was launched: its launch time is the
start of the CUDA API call that carries its correlation id,
or else the start of the operator or range it is linked to. Nothing is
written to disk: the profiler's events are read where they lie.

`summarize` works on plain `Range` and `DeviceOp` records, so the arithmetic
is tested without a card.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from benchmark.groups import TRACER_ROWS, group_of

PREFIX = "bench:"
WINDOW = "window"
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_KINDS = {"cuda_runtime", "cuda_driver"}


@dataclass
class Range:
    cat: str  # the name after "bench:"
    start: int  # ns
    end: int


@dataclass
class DeviceOp:
    name: str
    start: int  # ns, in the host's time base
    end: int
    launch: Optional[int]  # ns on the host; None where no link was found


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # device seconds by the set of range categories open at launch
    by_ranges: Dict[FrozenSet[str], float]
    counts: Dict[str, int]  # ranges of each category inside the window
    unlinked_s: float  # device seconds with no launch time
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def device_s(self, inside: str, outside: Iterable[str] = ()) -> float:
        """Device seconds launched inside a `inside` range and inside none of
        the `outside` categories."""
        out = set(outside)
        return sum(s for cats, s in self.by_ranges.items()
                   if inside in cats and not (cats & out))


class _Index:
    """Non-overlapping ranges of one category, for stabbing queries."""

    def __init__(self, ranges: List[Range]):
        self.ranges = sorted(ranges, key=lambda r: r.start)
        self.starts = [r.start for r in self.ranges]

    def find(self, t: int) -> Optional[Range]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.ranges[i].end >= t:
            return self.ranges[i]
        return None


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def summarize(ranges: List[Range], ops: List[DeviceOp], top: int = 10) -> TraceSummary:
    windows = [r for r in ranges if r.cat == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"expected one {PREFIX}{WINDOW} range, found {len(windows)}")
    w0, w1 = windows[0].start, windows[0].end
    by_cat: Dict[str, List[Range]] = defaultdict(list)
    for r in ranges:
        if r.cat != WINDOW and r.start >= w0 and r.end <= w1:
            by_cat[r.cat].append(r)
    index = {cat: _Index(rs) for cat, rs in by_cat.items()}

    by_ranges: Dict[FrozenSet[str], float] = defaultdict(float)
    groups: Dict[str, float] = defaultdict(float)
    intervals: List[Tuple[int, int]] = []
    unlinked = 0.0
    for op in ops:
        s, e = max(op.start, w0), min(op.end, w1)
        if e <= s:
            continue
        sec = (e - s) / 1e9
        intervals.append((s, e))
        groups[group_of(op.name)] += sec
        if op.launch is None:
            unlinked += sec
            continue
        cats = frozenset(cat for cat, ix in index.items() if ix.find(op.launch) is not None)
        by_ranges[cats] += sec
    busy = _merge(intervals)
    busy_s = sum(e - s for s, e in busy) / 1e9

    # Idle gaps, by the innermost range the host was in when each began.
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        inner = None
        for cat, ix in index.items():
            r = ix.find(gs)
            if r is not None and (inner is None or r.start > inner[1]):
                inner = (cat, r.start)
        gaps["host in " + (inner[0] if inner else "no bench range")] += (ge - gs) / 1e9
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_s, by_ranges=dict(by_ranges),
        counts={cat: len(rs) for cat, rs in by_cat.items()}, unlinked_s=unlinked,
        device_ops=sorted(groups.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top])


# ---- reading torch.profiler ----


def _ns(evt, what: str) -> int:
    fn = getattr(evt, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(evt, f"{what}_us")() * 1000)


def _kind(evt) -> Optional[str]:
    """The Kineto activity type, where this PyTorch's events carry it (2.11's
    do not: then runtime calls are told by their `cu` prefix)."""
    fn = getattr(evt, "activity_type", None)
    if fn is None:
        return None
    kind = fn()
    return kind if isinstance(kind, str) else str(kind)


def from_profiler(prof) -> Tuple[List[Range], List[DeviceOp]]:
    """Ranges and device operations of a finished torch.profiler session,
    read from its Kineto events without building the profiler's own tables."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ranges: List[Range] = []
    runtime: Dict[int, int] = {}
    cpu_ops: Dict[int, int] = {}
    device: List[Tuple[str, int, int, int, int]] = []
    for evt in events:
        name, kind = evt.name(), _kind(evt)
        start, dur = _ns(evt, "start"), _ns(evt, "duration")
        if evt.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                ranges.append(Range(name[len(PREFIX):], start, start + dur))
                cpu_ops[evt.correlation_id()] = start
            elif kind in RUNTIME_KINDS or (kind is None and name.startswith("cu")):
                runtime[evt.correlation_id()] = start
            else:
                cpu_ops[evt.correlation_id()] = start
        elif name.startswith(PREFIX) or name in TRACER_ROWS:
            continue  # the device-side shadow of a range, or the tracer's rows
        elif kind is None or kind in DEVICE_KINDS:
            device.append((name, start, start + dur, evt.correlation_id(),
                           evt.linked_correlation_id()))
    ops = []
    for name, s, e, corr, linked in device:
        launch = runtime.get(corr)
        if launch is None and linked:
            launch = cpu_ops.get(linked)
        ops.append(DeviceOp(name, s, e, launch))
    return ranges, ops
