"""Frames scored per second: every sampled frame of every question of every
request completed in the window, over the window's whole length."""

from benchmark.stats import window_rate


def read(run):
    return window_rate([r.frames * r.questions for r in run.requests], run.window_s)
