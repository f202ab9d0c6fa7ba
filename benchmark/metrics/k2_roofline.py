"""K2's share of its roofline (``benchmark/work/lag_corr.py``), in %."""

from harness.roofline import share


def read(record: dict):
    return share(record, "lag_corr")
