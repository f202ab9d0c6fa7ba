"""Host ms a hop copying the inputs into the graphed hop's static buffer (the
program's hop meter, ``stage`` span), mean over the window's unprofiled hops.

Per-layer metrics are read in a ``--trace 1`` run, whose profiler, loaded
on the last warm hop, leaves the process's CUDA runtime calls slower for
the rest of it (``cudaGraphLaunch`` about 3.8x on an H100's host): the
value compares commits, not the host's own cost, which an untraced process
shows (PERF.md, section 5)."""

from harness.meter import host_ms


def read(record: dict):
    return host_ms(record, "stage")
