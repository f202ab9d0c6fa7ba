"""Device ms of a rebuild hop's factorization: the Cholesky factors of the
two dark matrices and their triangular inverses, which the tracking
solver forms on the hops that refresh its preconditioner
(``apvast_torch/ops/jdiag.py::jdiag_topk_tracked``). The program's hop
meter's ``pencils`` -> ``factor`` section, the mean over the window's
sampled replays of the rebuild branch alone, unprofiled hops only
(``apvast_torch/observability.py``). None without a rebuild sample read in
the window or with one missed, and where the program's meter has no
per-branch reader."""

from harness.meter import window


def read(record: dict):
    w = window(record)
    branch_ms = getattr(w, "branch_ms", None)
    return None if branch_ms is None else branch_ms("factor", True)
