"""The linear work of the projector, the LM and the head (the program's
`linear` spans under `score`) as a share of its roofline: each span's
2 M K N operations at the bf16 or int8 peak, over the spans' device time,
in percent."""

from benchmark.program_spans import linear_roofline


def read(run):
    return linear_roofline(run, "score")
