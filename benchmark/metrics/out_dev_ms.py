"""Device ms a hop in sections 6+7, the input slide and the output synthesis (K5): the program's hop meter's timed marks,
captured into a twin of each branch graph that every ``SAMPLE_EVERY``-th
replay of the branch runs (``apvast_torch/observability.py``); each
branch's mean weighted by its share of the window's hops, unprofiled hops
only. None unless every branch the window's hops took has a sample and
none was missed."""

from harness.meter import section_ms


def read(record: dict):
    return section_ms(record, "out")
