"""Device ms a video in the `preprocess` range (SelectionEngine._preprocess:
the upload, the resize, the normalisation)."""


def read(run):
    t = run.trace
    n = t.counts.get("preprocess", 0) if t else 0
    took = t.device_s("preprocess") if n else 0.0
    return 1e3 * took / n if took else None
