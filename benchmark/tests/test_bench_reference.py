"""The float64 reference (``benchmark/reference``) at a tiny scene on the
CPU: its weighted buffers, pencils, cross vectors and span-V feeds against
the JAX package's NumPy oracle (``apvast_tpu/oracle/reference_np.py``, the
reference engine's semantics with SciPy's filters), and its feeds against
the port's exact path in float64. JAX runs on the CPU here only.

    python -m pytest benchmark/tests/test_bench_reference.py -q
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from apvast_tpu.config import ApVastConfig as JaxConfig  # noqa: E402
from apvast_tpu.oracle.reference_np import ReferenceApVast  # noqa: E402
from apvast_tpu.utils.rir import synthetic_rirs  # noqa: E402
from reference.hop import (  # noqa: E402
    Semantics,
    Tables,
    exact_top,
    feeds,
    rayleigh,
    segment_bounds,
    span_filter,
    statistics_pair,
)

S, M, L, BLOCK, J, N, V, D = 4, 3, 120, 128, 16, 100, 6, 5
HOP = BLOCK // 2
HOPS = 14
REL = 1e-9  # float64 throughout; the stages agree to ~1e-13


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def scene():
    ra, rb = synthetic_rirs(L, S, M, seed=1), synthetic_rirs(L, S, M, seed=2)
    x = np.random.default_rng(0).standard_normal((2, HOPS * HOP))
    sem = Semantics(S, M, L, BLOCK, J, D, 1, 2, V, 1.0, N, 8000, True, 94.0, "iso226_2003",
                    1e-7, 0.0)
    return ra, rb, x, sem


def _segment(x, sem, t):
    start, stop = segment_bounds(sem, t)
    seg = np.zeros((2, stop - start))
    lo = max(start, 0)
    seg[:, lo - start:] = x[:, lo:stop]
    return torch.as_tensor(seg)


def _reference(scene, t):
    ra, rb, x, sem = scene
    tables = Tables(sem, "cpu")
    rirs = torch.stack([torch.as_tensor(ra), torch.as_tensor(rb)])
    seg = _segment(x, sem, t)
    pencils = statistics_pair(sem, tables, rirs, seg)
    filters = [span_filter(sem, exact_top(sem, p)[1], p) for p in pencils]
    return pencils, feeds(sem, tables, seg, *filters)


@pytest.mark.parametrize("t", [9, 12])
def test_reference_against_the_oracle(scene, t):
    ra, rb, x, sem = scene
    cfg = JaxConfig.for_rirs(ra, rb, block_size=BLOCK, filter_length=J, modeling_delay=D,
                             reference_index_a=1, reference_index_b=2, num_eigenvectors=V,
                             mu=1.0, statistics_buffer_length=N, sampling_rate=8000,
                             perceptual=True, dtype="float64")
    oracle = ReferenceApVast(cfg, ra, rb, response_noise=(np.zeros((4, BLOCK, S, M)),
                                                          np.zeros((2, BLOCK, M))))
    kept = {}
    for tau in range(t + 1):
        out = oracle.process(x[0, tau * HOP:(tau + 1) * HOP], x[1, tau * HOP:(tau + 1) * HOP])
        if tau >= t - 1:
            kept[tau] = (oracle.wresp_stat.copy(), oracle.wtarget_stat.copy(),
                         oracle._statistics(), out)
    pencils, got = _reference(scene, t)
    for k, tau in enumerate((t - 1, t)):
        wresp, wtarget, (r_mats, r_vecs), _ = kept[tau]
        p = pencils[k]
        assert _rel(p["stat"], wresp.transpose(0, 3, 2, 1)) < REL
        assert _rel(p["tstat"], wtarget.transpose(0, 2, 1)) < REL
        assert _rel(p["a"], np.stack([r_mats[0], r_mats[3]])) < REL
        assert _rel(p["b"], np.stack([r_mats[1], r_mats[2]]) + 1e-7 * np.eye(S * J)) < REL
        assert _rel(p["r"], r_vecs) < REL
        vals, u = exact_top(sem, p)
        assert _rel(rayleigh(u, p), vals) < REL
    out = kept[t][3]
    for z in range(2):
        assert _rel(got[z], out[z][V - 1]) < 1e-9


def test_reference_against_the_port_exact_path(scene):
    """The port's default (exact, float64) configuration, hop by hop on the
    CPU: its span-V feeds equal the reference's from the exact
    eigenvectors."""
    from apvast_torch import ApVast

    ra, rb, x, sem = scene
    m = ApVast(BLOCK, ra, rb, J, D, 1, 2, V, 1.0, N, sampling_rate=8000, perceptual=True,
               device="cpu", dtype="float64", graph=False)
    t = 12
    for tau in range(t + 1):
        a, b, _, _ = m.process_input_buffers(x[0, tau * HOP:(tau + 1) * HOP],
                                             x[1, tau * HOP:(tau + 1) * HOP])
    _, got = _reference(scene, t)
    assert _rel(got[0], a[-1].numpy()) < 1e-8
    assert _rel(got[1], b[-1].numpy()) < 1e-8


def test_jacobi_copy_equals_the_kernels_formula():
    """The reference's frozen copy of K4's Jacobi formula gives what the
    port's plain form of the kernel gives, two sweeps from the same float32
    matrices (the rotation order decides the result, so it is held here)."""
    from apvast_torch.ops.kernels.jacobi_eigh import jacobi_eigh_plain
    from reference.jacobi import jacobi_eigh

    g = torch.Generator().manual_seed(7)
    x = torch.randn((3, 20, 20), generator=g)
    a = x @ x.transpose(-1, -2) + torch.diag_embed(torch.linspace(0.0, 5.0, 20)).expand(3, 20, 20)
    w_ref, v_ref = jacobi_eigh(a, 2)
    w, v = jacobi_eigh_plain(a, 2)
    assert _rel(w_ref, w) < 1e-6 and _rel(v_ref, v) < 1e-5
    w64, _ = jacobi_eigh(a.double(), 12)
    assert _rel(w64, torch.linalg.eigvalsh(a.double())) < 1e-12


def test_tracking_step_equals_the_ports_solver():
    """One step of the reference's tracker equals one step of the port's
    ``jdiag_topk_tracked`` in float64 (exact small eigensolve, direct
    Rayleigh-Ritz basis, one outer step) from the same basis and
    preconditioner: the same Ritz values, and the same span-V Rayleigh
    quotient sum."""
    import importlib

    from reference.hop import inverse_cholesky, tracking_step

    jdiag = importlib.import_module("apvast_torch.ops.jdiag")
    n, k, v = 40, 12, 8
    g = torch.Generator().manual_seed(3)
    xa, xb = torch.randn((2, n, 3 * n), generator=g, dtype=torch.float64).unbind(0)
    a = torch.stack([xa @ xa.T, xb @ xb.T]) / n
    b = torch.stack([xb @ xb.T, xa @ xa.T]) / n + 1e-3 * torch.eye(n, dtype=torch.float64)
    pencil = dict(a=a, b=b)
    q0 = torch.linalg.qr(torch.randn((2, n, k), generator=g, dtype=torch.float64))[0]
    lam0 = torch.linspace(2.0, 0.1, k, dtype=torch.float64).expand(2, k)
    li = inverse_cholesky(pencil)
    u, d, q, lam, _, _, _ = jdiag.jdiag_topk_tracked(
        a, b, 0.0, v, q0, lam0, li, False, outer_steps=1, small_eigh="lapack",
        rr_basis="direct")
    q_ref, lam_ref = tracking_step(pencil, q0, lam0, li, 2.0 ** -52 * 8, None)
    # The port's CholeskyQR2 loads its Gram matrices by 1e-6 of their
    # trace: its Ritz values carry that; its vectors' quotients do not.
    assert _rel(lam_ref, lam) < 1e-5
    assert _rel(rayleigh(q_ref[..., :v], pencil), rayleigh(u, pencil)) < 1e-9
