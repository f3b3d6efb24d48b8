"""The program's own spans (videoitg_tpu_torch/utils/profiling.py), read
after the traced window, for the per-layer metrics that look inside the
tower and the LM.

The program opens a `request` span at each engine entry and, under it,
`preprocess` (with `upload`, which counts its bytes), `tower` and one
`score` a question, with a `linear` span at every product (its operations,
2 M K N, and its kind, bf16 or int8) and an `attention` span at every
attention call; each span carries its device time from CUDA events. It
records while torch.profiler records, so after the traced window its buffer
holds that window's requests. The readers here only read: a program that
has no such tracer, a run with no device time (the CPU), or spans that do
not match the window's requests give None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark.roofline import PEAK_BF16, PEAK_INT8

OPS = ("linear", "attention")
TIMED = OPS + ("tower", "score", "upload")


def read_program():
    """The program's finished spans, or None where it has no tracer (a
    checkout before it)."""
    from videoitg_tpu_torch.utils import profiling

    read = getattr(profiling, "read", None)
    return read().spans if read is not None else None


def window_spans(run) -> Optional[list]:
    """The traced window's spans, each stage and op with its device time;
    None unless the window's `score` spans number its questions and its
    `tower` spans its encoded requests."""
    if run.trace is None or not run.requests:
        return None
    spans = read_program()
    if not spans:
        return None
    count = {"score": 0, "tower": 0}
    for s in spans:
        if s.name in count:
            count[s.name] += 1
    if (count["score"] != sum(r.questions for r in run.requests)
            or count["tower"] != sum(r.encoded for r in run.requests)):
        return None
    if any(s.device_ms is None for s in spans if s.name in TIMED):
        return None
    return spans


def stages(spans: list, name: str) -> List[Tuple[object, list]]:
    """Each `name` span with its children."""
    kids: Dict[Tuple[int, int], list] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault((s.request, s.parent), []).append(s)
    return [(s, kids.get((s.request, s.id), [])) for s in spans if s.name == name]


def linear_roofline(run, stage: str) -> Optional[float]:
    """The least time of the `linear` work under `stage` spans (each span's
    operations at the peak of its kind) over their device time, in percent."""
    spans = window_spans(run)
    if spans is None:
        return None
    least = took = 0.0
    for _, kids in stages(spans, stage):
        for k in kids:
            if k.name == "linear":
                least += k.args["ops"] / (PEAK_INT8 if k.args["kind"] == "int8" else PEAK_BF16)
                took += k.device_ms / 1e3
    return 100.0 * least / took if took > 0 else None


def rest_ms(run, stage: str) -> Optional[float]:
    """Device ms a `stage` span outside its `linear` and `attention`
    children: its self time, averaged over the spans."""
    spans = window_spans(run)
    if spans is None:
        return None
    per = [s.device_ms - sum(k.device_ms for k in kids if k.name in OPS)
           for s, kids in stages(spans, stage)]
    return sum(per) / len(per) if per else None


def upload_gbps(run) -> Optional[float]:
    """Bytes of the `upload` spans over their device seconds, in GB/s."""
    spans = window_spans(run)
    if spans is None:
        return None
    ups = [s for s in spans if s.name == "upload"]
    took = sum(s.device_ms for s in ups) / 1e3
    return sum(s.args["bytes"] for s in ups) / took / 1e9 if took > 0 else None
