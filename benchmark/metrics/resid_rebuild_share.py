"""Share of the window's hops that the residual trigger rebuilt (the program's
hop meter: each hop's rebuild decision by its cause, warmup, cadence or
residual)."""

from harness.meter import cause_share


def read(record: dict):
    return cause_share(record, "residual")
