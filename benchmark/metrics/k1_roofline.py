"""K1's share of its roofline (``benchmark/work/streaming_conv.py``), in %."""

from harness.roofline import share


def read(record: dict):
    return share(record, "streaming_conv")
