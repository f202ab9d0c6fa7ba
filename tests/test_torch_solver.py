"""The tracking GEVD solver of the port (``ops/jdiag.py``,
``ops/trisolve.py``) against the JAX functions on fixed pencils.

The solver runs in float64 with ``small_eigh="lapack"`` on both sides,
so only rounding separates them: outputs agree to 1e-9 of their scale
(1e-7 for the carried inverse factor, which the port gets by
substitution and JAX by blocked Neumann doubling), and the carried Ritz
vectors to 1e-9 after matching each column's sign. The triangular
inverses are held to their contract (L^-1 L = I) at the tolerances of the
JAX package's own tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops.jdiag import _cholqr2, jdiag, jdiag_topk_tracked
from apvast_torch.ops.trisolve import neumann_tri_inverse, triangular_inverse
from apvast_tpu.ops.jdiag import _cholqr2 as jax_cholqr2
from apvast_tpu.ops.jdiag import jdiag_batched as jax_jdiag
from apvast_tpu.ops.jdiag import jdiag_topk_tracked as jax_tracked
from apvast_tpu.ops.trisolve import neumann_tri_inverse as jax_neumann
from apvast_tpu.ops.trisolve import triangular_inverse as jax_triangular_inverse
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", [7, 50, 64, 128])
def test_neumann_tri_inverse_equals_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n, n + 4))
    chol = np.linalg.cholesky(x @ np.swapaxes(x, 1, 2) + n * np.eye(n))
    got = neumann_tri_inverse(_t(chol)).numpy()
    assert _rel(got, jax_neumann(jnp.asarray(chol))) <= 1e-12
    np.testing.assert_allclose(got @ chol, np.broadcast_to(np.eye(n), (3, n, n)), atol=1e-10)


def test_neumann_tri_inverse_zero_diagonal_stays_finite():
    """A semi-definite Gram (a silent block) factors with zero pivots; the
    guard keeps the inverse finite, as in JAX."""
    l = np.tril(np.ones((6, 6)))
    l[3:, 3:] = 0.0
    got = neumann_tri_inverse(_t(l)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, np.asarray(jax_neumann(jnp.asarray(l))))


@pytest.mark.parametrize("n", [48, 64, 800])
def test_triangular_inverse_equals_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, n + 4))
    chol = np.linalg.cholesky(x @ x.T + n * np.eye(n))
    got = triangular_inverse(_t(chol)).numpy()
    want = np.asarray(jax_triangular_inverse(jnp.asarray(chol)))
    assert _rel(got, want) <= 1e-10
    np.testing.assert_allclose(got @ chol, np.eye(n), atol=1e-8)
    assert np.allclose(np.triu(got, 1), 0.0)


def test_triangular_inverse_of_a_small_batch():
    """A batch of (12, 12) factors (the (2k, 2k) Rayleigh-Ritz pencil at
    k = 6): the JAX function cannot take it (its blocking falls back to a
    solve against an unbatched identity, ROADMAP Queue 3); the port's
    substitution serves any batch."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 12, 16))
    chol = np.linalg.cholesky(x @ np.swapaxes(x, 1, 2) + 12 * np.eye(12))
    got = triangular_inverse(_t(chol)).numpy()
    np.testing.assert_allclose(got @ chol, np.broadcast_to(np.eye(12), (2, 12, 12)), atol=1e-12)
    with pytest.raises(ValueError):
        jax_triangular_inverse(jnp.asarray(chol))


def test_failed_factorization_gives_nans_not_an_error():
    """A dark matrix that is not positive definite: JAX's exact solver
    returns NaNs, which the hop's ``silenced`` count sees; the port does the
    same where torch's Cholesky and eigh would raise (ROADMAP Queue 3)."""
    rng = np.random.default_rng(13)
    a, b = _pencils(rng, 2, 10)
    b[1] = -b[1]
    u, d = jdiag(_t(a), _t(b), 1e-7)
    ju, jd = jax_jdiag(jnp.asarray(a), jnp.asarray(b), 1e-7)
    assert np.isnan(u[1].numpy()).all() and np.isnan(d[1].numpy()).all()
    assert np.isnan(np.asarray(ju[1])).all()
    assert np.isfinite(u[0].numpy()).all()
    assert _rel(d[0].numpy(), np.asarray(jd[0])) <= 1e-9


def test_triangular_inverse_jl1600_float32():
    """The float32 n = 1600 factor on which Neumann doubling of 100-row
    blocks overflowed in JAX: both inverses stay finite with a residual
    below 1e-2 (tests/test_subspace_solver.py)."""
    rng = np.random.default_rng(1600)
    n = 1600
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = 1e-6 * (np.geomspace(1.0, 1e-6, n) + 1e-6)
    spd = (q * ev) @ q.T
    spd = 0.5 * (spd + spd.T) + 1e-9 * np.eye(n)
    chol = np.linalg.cholesky(spd).astype(np.float32)
    for li in (triangular_inverse(_t(chol)).numpy(),
               np.asarray(jax_triangular_inverse(jnp.asarray(chol)))):
        assert np.isfinite(li).all()
        resid = li.astype(np.float64) @ chol.astype(np.float64) - np.eye(n)
        assert np.abs(resid).max() < 1e-2


def test_cholqr2_equals_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 60, 12))
    q[1, :, 5] = q[1, :, 4]  # a rank-deficient block: the jitter keeps it finite
    got = _cholqr2(_t(q)).numpy()
    want = np.stack([np.asarray(jax_cholqr2(jnp.asarray(q[i]))) for i in range(2)])
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-9
    # The Gram's 1e-6 trace-relative jitter bounds the orthonormality.
    np.testing.assert_allclose(np.swapaxes(got[0], -1, -2) @ got[0], np.eye(12), atol=1e-5)


def _pencils(rng, z, n, extra=8):
    xa = rng.standard_normal((z, n, n + extra))
    xb = rng.standard_normal((z, n, n + extra))
    return xa @ np.swapaxes(xa, 1, 2), xb @ np.swapaxes(xb, 1, 2)


def _halves(r):
    """M with M + M^T = R: the lower triangle, diagonal halved."""
    m = np.tril(r)
    idx = np.arange(r.shape[-1])
    m[..., idx, idx] *= 0.5
    return m


@pytest.mark.parametrize("rebuild", [True, False], ids=["rebuild", "carried"])
@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("basis", ["cholqr2", "direct"])
def test_tracked_equals_jax(basis, half, rebuild):
    rng = np.random.default_rng(11)
    z, n, k, top, reg = 2, 40, 12, 5, 1e-7
    a, b = _pencils(rng, z, n)
    q0 = rng.standard_normal((z, n, k))
    lam0 = np.abs(rng.standard_normal((z, k)))
    # A carried factor of a nearby pencil (the stale preconditioner).
    _, b_old = _pencils(rng, z, n)
    li0 = np.linalg.inv(np.linalg.cholesky(b + 0.3 * b_old + reg * np.eye(n)))
    am, bm = (_halves(a), _halves(b)) if half else (a, b)
    kwargs = dict(outer_steps=2, rr_basis=basis, half_form=half)
    got = jdiag_topk_tracked(
        _t(am), _t(bm), reg, top, _t(q0), _t(lam0), _t(li0), rebuild, **kwargs
    )
    want = jax_tracked(
        jnp.asarray(am), jnp.asarray(bm), reg, top, jnp.asarray(q0), jnp.asarray(lam0),
        jnp.asarray(li0), jnp.asarray(rebuild), **kwargs,
    )
    u, d, q, lam, li, silenced, resid = (x.numpy() for x in got)
    ju, jd, jq, jlam, jli, jsil, jres = (np.asarray(x) for x in want)
    assert int(silenced) == int(jsil) == 0
    # Eigenvector signs are LAPACK's choice (the span filters (u.r) u do
    # not see them): vectors are compared column sign matched.
    assert _rel(_sign_aligned(u, ju), ju) <= 1e-9
    assert _rel(d, jd) <= 1e-9 and _rel(lam, jlam) <= 1e-9
    assert _rel(_sign_aligned(q, jq), jq) <= 1e-9
    assert _rel(li, jli) <= 1e-7
    assert resid.dtype == np.float32 and abs(float(resid) - float(jres)) <= 1e-6 * float(jres)
    if not rebuild:
        np.testing.assert_array_equal(li, li0)  # the carried factor passes through
    # Extraction contract: U^T (B + reg I) U = I.
    g = np.swapaxes(u, -1, -2) @ (b + reg * np.eye(n)) @ u
    np.testing.assert_allclose(g, np.broadcast_to(np.eye(top), g.shape), atol=1e-6)


def _sign_aligned(v, ref):
    s = np.sign(np.sum(v * ref, axis=-2))
    return v * s[..., None, :]


def test_silent_pencil_restarts_from_identity():
    """The silence-gap guard: a zero pencil and a zero incoming basis give
    an identity restart, zero outputs and a residual of +inf (so the next
    hop rebuilds), in both packages. (k = 8: the JAX triangular_inverse
    cannot take a batch of (2k, 2k) factors with 2k < 16, ROADMAP Queue 3.)"""
    z, n, k = 2, 16, 8
    zeros = np.zeros((z, n, n))
    q0, lam0 = np.zeros((z, n, k)), np.zeros((z, k))
    li0 = np.broadcast_to(np.eye(n), (z, n, n)).copy()
    got = jdiag_topk_tracked(_t(zeros), _t(zeros), 1e-7, 3, _t(q0), _t(lam0), _t(li0), True,
                             outer_steps=1, rr_basis="direct", half_form=True)
    want = jax_tracked(jnp.asarray(zeros), jnp.asarray(zeros), 1e-7, 3, jnp.asarray(q0),
                       jnp.asarray(lam0), jnp.asarray(li0), jnp.asarray(True),
                       outer_steps=1, rr_basis="direct", half_form=True)
    u, d, q, lam, li, silenced, resid = (x.numpy() for x in got)
    assert float(resid) == np.inf == float(want[6])
    assert np.isfinite(q).all()
    assert np.min(np.sum(q * q, axis=-2)) > 1e-20  # never the absorbing zero basis
    assert int(silenced) == int(want[5])
    np.testing.assert_allclose(q, np.asarray(want[2]), atol=1e-12)


def test_non_finite_inputs_self_heal():
    """A NaN in the incoming basis restarts that zone; a failed fresh
    factorization keeps the carried factor; non-finite outputs are zeroed
    and counted."""
    rng = np.random.default_rng(5)
    z, n, k, top, reg = 2, 24, 8, 4, 1e-7
    a, b = _pencils(rng, z, n)
    q0 = rng.standard_normal((z, n, k))
    q0[0, 3, 2] = np.nan
    lam0 = np.ones((z, k))
    li0 = np.linalg.inv(np.linalg.cholesky(b + reg * np.eye(n)))
    b_bad = b.copy()
    b_bad[1, 0, 0] = -1e6  # not positive definite: the fresh factor is NaN
    args = (reg, top)
    got = jdiag_topk_tracked(_t(a), _t(b_bad), *args, _t(q0), _t(lam0), _t(li0), True,
                             outer_steps=1)
    want = jax_tracked(jnp.asarray(a), jnp.asarray(b_bad), *args, jnp.asarray(q0),
                       jnp.asarray(lam0), jnp.asarray(li0), jnp.asarray(True), outer_steps=1)
    u, d, q, lam, li, silenced, resid = (x.numpy() for x in got)
    np.testing.assert_array_equal(li[1], li0[1])  # fresh NaN factor -> carried one
    assert np.isfinite(q).all() and np.isfinite(u).all() and np.isfinite(d).all()
    assert float(resid) == np.inf == float(want[6])  # zone 0 came in unhealthy
    assert int(silenced) == int(want[5])
    assert _rel(_sign_aligned(u, np.asarray(want[0])), np.asarray(want[0])) <= 1e-9
