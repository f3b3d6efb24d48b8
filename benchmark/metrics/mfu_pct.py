"""The whole request's share of the card's peak: the least time of the work
completed in the traced window (every linear at 2 M K N at the bf16 or int8
peak, attention at its roofline, counted from each request's shapes; a
question's part by the configuration's architecture module where it counts
its own) over the window, in percent."""

from benchmark.roofline import request_work


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    model, tier = run.cfg["model"], run.cfg.get("tier")
    least = sum(request_work(model, tier, r.frames,
                             min(len(r.instruction) + 1, model["max_text_len"]),
                             r.encoded, run.arch).least_s * r.questions
                for r in run.requests)
    return 100.0 * least / t.window_s
