"""Host-to-device rate of the frames' upload: bytes counted by the
program's `upload` spans over their device seconds, in GB/s."""

from benchmark.program_spans import upload_gbps


def read(run):
    return upload_gbps(run)
