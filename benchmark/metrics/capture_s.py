"""Seconds of set-up capturing the hop's CUDA graphs (the program's hop meter,
``capture`` spans: the warm pass and every branch's capture)."""

from harness.meter import setup_s


def read(record: dict):
    return setup_s("capture")
