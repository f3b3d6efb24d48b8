"""Device ms a video in the `tower` range (vision_features: the SigLIP tower
over the video's frames, in chunks)."""


def read(run):
    t = run.trace
    n = t.counts.get("tower", 0) if t else 0
    took = t.device_s("tower") if n else 0.0
    return 1e3 * took / n if took else None
