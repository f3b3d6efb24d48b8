"""The tower's attention (siglip's calls of ops/attention.mha) as a share of
its roofline: the least time of every call, counted from its shapes, over
the device time launched inside those calls, in percent."""

from benchmark.roofline import bound_seconds


def read(run):
    if run.trace is None or run.calls is None:
        return None
    work = run.calls.attention_work("siglip.mha")
    took = run.trace.device_s("siglip.mha")
    return 100.0 * sum(bound_seconds(o, b) for o, b in work) / took if work and took else None
