"""K5's share of its roofline (``benchmark/work/output_filter.py``), in %."""

from harness.roofline import share


def read(record: dict):
    return share(record, "output_filter")
