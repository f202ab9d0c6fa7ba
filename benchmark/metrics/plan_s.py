"""Seconds of set-up building the model's plan (the program's hop meter,
``plan`` spans: ``build_plan`` in the model's constructor)."""

from harness.meter import setup_s


def read(record: dict):
    return setup_s("plan")
