"""The allocator's peak over the window (statistics reset at its start),
weights included: torch.cuda.max_memory_allocated, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
