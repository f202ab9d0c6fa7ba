"""K3's share of its roofline (``benchmark/work/skew_assembly.py``), in %."""

from harness.roofline import share


def read(record: dict):
    return share(record, "skew_assembly")
