"""Seconds from the process's start to the first timed hop: imports, the
kernels' libraries loaded (built on a checkout's first run), the inputs
made from the seed, the plan, both graph branches captured, the warm
hops."""


def read(record: dict):
    return record["setup_s"]
