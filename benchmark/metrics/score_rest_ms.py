"""Device ms a question in the program's `score` spans outside their
`linear` and `attention` children: RMSNorm, RoPE, SiLU x up, residuals,
the frame pooling, the embedding lookup, the read back."""

from benchmark.program_spans import rest_ms


def read(run):
    return rest_ms(run, "score")
