"""The tower's linear work (the program's `linear` spans under `tower`:
the patch embedding and every encoder product, or kernels G, H and I) as a
share of its roofline: each span's 2 M K N operations at the bf16 or int8
peak, over the spans' device time, in percent."""

from benchmark.program_spans import linear_roofline


def read(run):
    return linear_roofline(run, "tower")
