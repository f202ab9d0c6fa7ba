"""The 99th percentile (nearest rank) of the host-clock times of every
hop in the window, in ms: from handing in the programs' blocks to the
played span's feeds being in host memory."""

from harness.drive import percentile


def read(record: dict):
    return 1e3 * percentile(record["hop_s"], 99.0)
