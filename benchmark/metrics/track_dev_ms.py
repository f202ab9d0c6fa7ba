"""Device ms a hop of the tracking solver's step: the block residual, its
preconditioning by the carried inverse Cholesky factor, Rayleigh-Ritz on
the widened basis and the Jacobi sweeps (K4). The program's hop meter's
``factor`` -> ``track`` section (``apvast_torch/observability.py``), each
branch's mean weighted by its share of the window's hops, unprofiled hops
only. None unless every branch the window's hops took has a sample and
none was missed, and where the program's meter has no such section."""

from harness.meter import window


def read(record: dict):
    w = window(record)
    if w is None:
        return None
    from apvast_torch.observability import SECTIONS

    return w.section_ms("track") if "track" in SECTIONS else None
