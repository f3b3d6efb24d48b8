"""Device ms a question in the `score` range (grounding_logits or
score_encoded: projector, LM and head), outside the tower and preprocess
ranges."""


def read(run):
    t = run.trace
    n = t.counts.get("score", 0) if t else 0
    took = t.device_s("score", outside=("tower", "preprocess")) if n else 0.0
    return 1e3 * took / n if took else None
