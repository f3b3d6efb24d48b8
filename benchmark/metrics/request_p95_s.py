"""Nearest-rank 95th percentile of the latency of every request completed in
the window, from its issue on the host to its scores on the host."""

from benchmark.stats import nearest_rank


def read(run):
    return nearest_rank([r.latency_s for r in run.requests], 95)
