"""K4's share of its roofline (``benchmark/work/jacobi_eigh.py``), in %."""

from harness.roofline import share


def read(record: dict):
    return share(record, "jacobi_eigh")
