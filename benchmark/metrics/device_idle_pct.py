"""Share of the traced window in which no kernel, copy or fill ran on the
device, in percent."""


def read(run):
    t = run.trace
    # No device operation at all means no device was traced: nothing to read.
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.busy_s > 0 else None
