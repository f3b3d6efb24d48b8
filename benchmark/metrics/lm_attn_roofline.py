"""The LM's attention (qwen2's calls of ops/attention.mha) as a share of its
roofline: the least time of every call, counted from its shapes and its key
mask (valid queries x valid keys), over the device time launched inside
those calls, in percent."""

from benchmark.roofline import bound_seconds


def read(run):
    if run.trace is None or run.calls is None:
        return None
    work = run.calls.attention_work("qwen2.mha")
    took = run.trace.device_s("qwen2.mha")
    return 100.0 * sum(bound_seconds(o, b) for o, b in work) / took if work and took else None
