"""Host ms a hop in the entry, the model's hop call less the graph's spans
(input checks and conversions, the outputs' clones, the rebuild and silenced
accounting): the program's hop meter, ``entry`` less ``stage``, ``resid`` and
``launch``, mean over the window's unprofiled hops.

Per-layer metrics are read in a ``--trace 1`` run, whose profiler, loaded
on the last warm hop, leaves the process's CUDA runtime calls slower for
the rest of it (``cudaGraphLaunch`` about 3.8x on an H100's host): the
value compares commits, not the host's own cost, which an untraced process
shows (PERF.md, section 5)."""

from harness.meter import host_ms


def read(record: dict):
    return host_ms(record, "entry")
