"""Device ms a video in the program's `tower` spans outside their `linear`
and `attention` children: norms, activations, residuals, copies, and any
idle inside the tower."""

from benchmark.program_spans import rest_ms


def read(run):
    return rest_ms(run, "tower")
