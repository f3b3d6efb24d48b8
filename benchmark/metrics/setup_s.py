"""Process start to the first timed request: traffic and weights made on the
device from the seed, the model loaded (and quantised in its tier), the
kernels built or loaded, the window's shapes warmed."""


def read(run):
    return run.setup_s
