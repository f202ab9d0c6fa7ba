"""K7 and the frequency-domain engine's small solvers on the CPU, against
the JAX package and a float64 NumPy oracle.

- K7's plain version (``jacobi_eigh_hermitian_plain``, the wrapper's CPU
  path) against the JAX Pallas kernel in interpret mode and against
  ``numpy.linalg.eigh``. Eigenvectors are defined up to a complex phase
  and, inside the real embedding, every eigenvalue is doubled, so rounding
  picks the basis of each pair: only phase-invariant quantities are
  compared (eigenvalues, the residual |Hq - qw| / |H|, |q^H q - I|, and
  the rank-one projectors q_i q_i^H of well-separated eigenvalues).
  Tolerances: float32 Jacobi with sums in another order; the eigenvalues
  agree with JAX's within 1e-5 of their scale and with the float64 oracle
  within 2e-4 (as tests/test_jacobi_eigh.py holds the TPU kernel), the
  residual and orthonormality within 5e-5 at 8-10 sweeps on random
  matrices, and within the TPU test's 1e-3 / 5e-3 on the degenerate-pairs
  spectrum.
- ``cholesky_small`` and ``posdef_solve_small`` against JAX in float64
  (1e-12: the same unrolled algorithm), including the pivot floor.
- ``jdiag_hermitian`` / ``jdiag_hermitian_batched``: the GEVD contract
  U^H A U = diag(d) descending, U^H B_reg U = I, against JAX in float64
  (1e-9), and the "jacobi" branch's per-rank filters cumsum(coef u), which
  do not depend on the phase, against JAX's in float32 (1e-4 of scale).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_torch.ops.jdiag import jdiag_hermitian, jdiag_hermitian_batched
from apvast_torch.ops.kernels.jacobi_eigh import _rank, padded_size, relabeled_pairs
from apvast_torch.ops.kernels.jacobi_eigh_hermitian import embed, select_pairs
from apvast_torch.ops.small_chol import cholesky_small, posdef_solve_small
from apvast_tpu.ops.jdiag import jdiag_hermitian_batched as jax_jdiag_hermitian_batched
from apvast_tpu.ops.pallas.jacobi_eigh import jacobi_eigh as jax_jacobi_eigh
from apvast_tpu.ops.pallas.jacobi_eigh import jacobi_eigh_hermitian as jax_jacobi_hermitian
from apvast_tpu.ops.small_chol import cholesky_small as jax_cholesky_small
from apvast_tpu.ops.small_chol import posdef_solve_small as jax_posdef_solve_small
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _herm(rng, b, n):
    x = rng.standard_normal((b, n, n)) + 1j * rng.standard_normal((b, n, n))
    return (0.5 * (x + np.conj(np.swapaxes(x, 1, 2)))).astype(np.complex64)


def _psd(rng, b, n, extra=4):
    x = rng.standard_normal((b, n, n + extra)) + 1j * rng.standard_normal((b, n, n + extra))
    return x @ np.conj(np.swapaxes(x, 1, 2))


def _degenerate(rng):
    """The spectrum of tests/test_jacobi_eigh.py's degenerate-pairs test:
    two exact 2-fold degeneracies and a pair 1 float32 ulp apart."""
    n, bz = 8, 6
    z = rng.standard_normal((bz, n, n)) + 1j * rng.standard_normal((bz, n, n))
    q, _ = np.linalg.qr(z)
    w0 = np.array(
        [1.0, 1.0, 2.0, 2.0, 3.0, np.float32(3.0) + np.spacing(np.float32(3.0)), 5.0, 8.0],
        np.float64,
    )
    a = (q * w0[None, None, :].astype(q.dtype)) @ np.conj(q.swapaxes(-1, -2))
    return (0.5 * (a + np.conj(a.swapaxes(-1, -2)))).astype(np.complex64)


def _residual(a, w, v):
    a, w, v = (np.asarray(x, np.complex128) for x in (a, w, v))
    res = np.einsum("bij,bjk->bik", a, v) - v * w.real[:, None, :]
    g = np.einsum("bij,bik->bjk", v.conj(), v)
    return float(np.abs(res).max() / np.abs(a).max()), float(np.abs(g - np.eye(a.shape[-1])).max())


def _plain(a, sweeps):
    w, v = K.jacobi_eigh_hermitian(torch.from_numpy(a), sweeps)  # CPU: the plain version
    return w.numpy(), v.numpy()


@pytest.mark.parametrize("n,bz,sweeps", [(1, 3, 4), (4, 5, 8), (5, 3, 10), (8, 9, 8), (16, 4, 10)])
def test_hermitian_plain_matches_jax_and_oracle(rng, n, bz, sweeps):
    a = _herm(rng, bz, n)
    w, v = _plain(a, sweeps)
    jw, jv = jax.jit(lambda x: jax_jacobi_hermitian(x, sweeps=sweeps, interpret=True))(a)
    jw, jv = np.asarray(jw), np.asarray(jv)
    wn = np.linalg.eigvalsh(a.astype(np.complex128))
    scale = np.abs(wn).max()
    assert w.shape == (bz, n) and v.shape == (bz, n, n) and v.dtype == np.complex64
    assert np.abs(w - jw).max() <= 1e-5 * scale
    assert np.abs(w - wn).max() <= 2e-4 * scale
    res, orth = _residual(a, w, v)
    assert res <= 5e-5 and orth <= 5e-5
    # Rank-one projectors of eigenvalues separated from their neighbors by
    # more than 1e-2 of the scale: phase-free, and determined.
    gaps = np.diff(wn, axis=-1)
    sep = np.ones_like(wn, bool)
    sep[:, 1:] &= gaps > 1e-2 * scale
    sep[:, :-1] &= gaps > 1e-2 * scale
    proj = np.einsum("bij,bkj->bjik", v, v.conj())
    jproj = np.einsum("bij,bkj->bjik", jv, jv.conj())
    assert np.abs(proj - jproj)[sep].max() <= 1e-4


def _pair_block_rounds_real(a: torch.Tensor, sweeps: int):
    """A float32 emulation of the card's pair-block form on a real
    symmetric batch (K4's, and K7's on the embedding): K4's rotations, each
    round applied in place to the physical slot pairs of the relabeled
    table (nothing moves), then K4's ranking and output gather."""
    bz, n, _ = a.shape
    npad = padded_size(n)
    a = torch.nn.functional.pad(a.float(), (0, npad - n, 0, npad - n))
    v = torch.eye(npad).repeat(bz, 1, 1)
    pairs = torch.from_numpy(relabeled_pairs(npad))
    for _ in range(sweeps):
        for p, q in zip(pairs[..., 0], pairs[..., 1]):  # round k's P and Q slots
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            theta = aqq - app
            sg = torch.where(theta >= 0, 1.0, -1.0)
            t = 2.0 * apq * sg / (theta.abs() + torch.sqrt(theta * theta + 4.0 * apq * apq) + 1e-30)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            cc, sc = c[:, None, :], s[:, None, :]
            for m in (a, v):  # columns: M R (advanced indexing copies)
                mp, mq = m[:, :, p], m[:, :, q]
                m[:, :, p], m[:, :, q] = mp * cc - mq * sc, mq * cc + mp * sc
            cr, sr = c[..., None], s[..., None]
            ap, aq = a[:, p, :], a[:, q, :]  # rows: R^T (A R)
            a[:, p, :], a[:, q, :] = cr * ap - sr * aq, cr * aq + sr * ap
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    perm = (_rank(w, n)[:, :, None] == torch.arange(n)).float()
    return torch.einsum("bi,bic->bc", w, perm), (v @ perm)[:, :n, :]


def _pair_block_rounds(h: torch.Tensor, sweeps: int):
    """The emulation of the card's pair-block form of K7: the real form on
    the embedding, then the pair selection."""
    n = h.shape[-1]
    return select_pairs(*_pair_block_rounds_real(embed(h), sweeps), n)


@pytest.mark.parametrize("n,bz,sweeps", [(5, 3, 10), (8, 9, 8), (16, 4, 6)])
def test_pair_block_rounds_match_plain_and_jax(rng, n, bz, sweeps):
    """The in-place rounds along the relabeled pair table give the moving
    schedule's eigenvalues: within 1e-5 of scale of the plain version (the
    TPU wrapper's formula) and of the JAX kernel in interpret mode (the
    tolerance of test_hermitian_plain_matches_jax_and_oracle)."""
    a = _herm(rng, bz, n)
    w, v = _pair_block_rounds(torch.from_numpy(a), sweeps)
    wp, _ = _plain(a, sweeps)
    jw, _ = jax.jit(lambda x: jax_jacobi_hermitian(x, sweeps=sweeps, interpret=True))(a)
    scale = np.abs(np.linalg.eigvalsh(a.astype(np.complex128))).max()
    assert np.abs(w.numpy() - wp).max() <= 1e-5 * scale
    assert np.abs(w.numpy() - np.asarray(jw)).max() <= 1e-5 * scale
    if sweeps >= 8:  # converged: unit eigenvectors
        res, orth = _residual(a, w.numpy(), v.numpy())
        assert res <= 5e-5 and orth <= 5e-5


@pytest.mark.parametrize("n", [10, 22, 64])
def test_pair_block_rounds_real_match_plain_and_jax(n):
    """The real form of the in-place rounds (K4's pair-block form) on
    warm-start-like inputs at the production count of 2 sweeps: eigenvalues
    and eigenvectors element for element within 1e-5 of the plain version
    (the TPU wrapper's formula) and of the JAX kernel in interpret mode,
    the tolerance of test_torch_jacobi.py's two-sweep comparison (n = 10
    and 22 pad to 16 and 24 slots)."""
    rng = np.random.default_rng(n)
    e = 1e-2 * rng.standard_normal((3, n, n))
    a = (np.linspace(-3.0, 5.0, n) * np.eye(n) + (e + np.swapaxes(e, 1, 2)) / 2).astype(np.float32)
    w, v = _pair_block_rounds_real(torch.from_numpy(a), 2)
    wp, vp = K.jacobi_eigh(torch.from_numpy(a), 2)  # CPU: the plain version
    jw, jv = jax_jacobi_eigh(jnp.asarray(a), sweeps=2, interpret=True)
    for got, want in ((w, wp), (v, vp), (w, jw), (v, jv)):
        want = np.asarray(want, np.float64)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_hermitian_plain_serves_widths_past_64(rng):
    """n = 72 embeds into 144 slots, past the card's former shared-memory
    bound of 128: the plain version (the CPU path) serves it, as JAX does,
    on a warm-start-like input (spread real diagonal, small Hermitian
    perturbation) at 2 sweeps.

    Two sweeps leave this width unconverged on either side (residual ~5e-4,
    |q^H q - I| ~2.5e-3 for both), so the eigenvectors are held by their
    residual and orthonormality within 1.5x JAX's own. The eigenvalues:
    at 144 slots the float32 floor is about 1e-5 of scale (JAX's own
    distance from the float64 oracle after 3 sweeps is 5e-6, the port's
    1e-5), so 2e-5 of scale against JAX and 2e-4 against the oracle."""
    n = 72
    a = (np.diag(np.linspace(-3.0, 5.0, n)) + 1e-2 * _herm(rng, 1, n)).astype(np.complex64)
    w, v = _plain(a, 2)
    jw, jv = jax.jit(lambda x: jax_jacobi_hermitian(x, sweeps=2, interpret=True))(a)
    jw, jv = np.asarray(jw), np.asarray(jv)
    wn = np.linalg.eigvalsh(a.astype(np.complex128))
    scale = np.abs(wn).max()
    assert w.shape == (1, n) and v.shape == (1, n, n) and v.dtype == np.complex64
    assert np.abs(w - jw).max() <= 2e-5 * scale
    assert np.abs(w - wn).max() <= 2e-4 * scale
    for got, want in zip(_residual(a, w, v), _residual(a, jw, jv)):
        assert got <= 1.5 * want


def test_hermitian_plain_degenerate_pairs(rng):
    """Exact 2-fold degeneracies and a 1-ulp pair: the re-pairing repair
    and the Gram-Schmidt pass keep the columns orthonormal; the kernel's
    plain version holds what the TPU kernel holds."""
    a = _degenerate(rng)
    w, v = _plain(a, 10)
    jw, _ = jax.jit(lambda x: jax_jacobi_hermitian(x, sweeps=10, interpret=True))(a)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(a), atol=2e-4 * 8)
    np.testing.assert_allclose(w, np.asarray(jw), atol=1e-5 * 8)
    res, orth = _residual(a, w, v)
    assert res <= 1e-3 and orth <= 5e-3


def test_select_pairs_repairs_an_interleaved_pair():
    """An interleaved ranking (l1, l2, l1, l2) selects two copies of one
    complex vector; the repair takes the odd neighbour instead, and its
    eigenvalue."""
    n = 2
    u1 = np.array([1.0, 0.0, 0.0, 0.0])  # (u; v) of e1
    j1 = np.array([0.0, 0.0, 1.0, 0.0])  # its J-partner (-v; u): i e1
    u2 = np.array([0.0, 1.0, 0.0, 0.0])
    v2 = torch.tensor(np.stack([u1, u2, j1, np.array([0.0, 0.0, 0.0, 1.0])], 1), dtype=torch.float32)
    w2 = torch.tensor([[1.0, 2.0, 1.0, 2.0]])
    # Columns 0 and 2 (the selected ones) are e1 and i e1: a duplicate.
    w, q = select_pairs(w2, v2[None], n)
    assert torch.equal(w, torch.tensor([[1.0, 2.0]]))
    g = q[0].conj().T @ q[0]
    torch.testing.assert_close(g, torch.eye(2, dtype=torch.complex64))


def test_embedding_is_symmetric_with_paired_spectrum(rng):
    a = _herm(rng, 3, 5)
    t = embed(torch.from_numpy(a)).double()
    torch.testing.assert_close(t, t.transpose(1, 2), rtol=0, atol=0)
    w2 = torch.linalg.eigvalsh(t)
    torch.testing.assert_close(w2[:, 0::2], w2[:, 1::2], rtol=0, atol=1e-5)


def test_hermitian_wrapper_refuses_bad_input():
    h = torch.zeros((2, 4, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        K.jacobi_eigh_hermitian(h.to(torch.complex128), 4)
    with pytest.raises(ValueError, match="complex64"):
        K.jacobi_eigh_hermitian(h.real.contiguous(), 4)
    with pytest.raises(ValueError, match="square"):
        K.jacobi_eigh_hermitian(torch.zeros((2, 4, 3), dtype=torch.complex64), 4)
    with pytest.raises(ValueError, match="contiguous"):
        K.jacobi_eigh_hermitian(h.transpose(1, 2), 4)
    with pytest.raises(ValueError, match="sweeps"):
        K.jacobi_eigh_hermitian(h, -1)
    w, q = K.jacobi_eigh_hermitian(torch.zeros((1, 64, 64), dtype=torch.complex64), 0)
    assert w.shape == (1, 64) and q.shape == (1, 64, 64)


@pytest.mark.parametrize("n,complex_", [(1, True), (8, True), (16, True), (32, True), (6, False)])
def test_cholesky_small_matches_jax(rng, n, complex_):
    h = _psd(rng, 5, n) if complex_ else _psd(rng, 5, n).real + 0.0
    h = h + 1e-3 * np.eye(n)
    got = cholesky_small(torch.from_numpy(h)).numpy()
    want = np.asarray(jax_cholesky_small(jnp.asarray(h)))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert np.all(np.triu(got, 1) == 0)
    np.testing.assert_allclose(got, np.linalg.cholesky(h), rtol=0, atol=1e-10 * np.abs(want).max())
    r = rng.standard_normal((5, n, 2)) + (1j * rng.standard_normal((5, n, 2)) if complex_ else 0)
    x = posdef_solve_small(torch.from_numpy(h), torch.from_numpy(r)).numpy()
    xj = np.asarray(jax_posdef_solve_small(jnp.asarray(h), jnp.asarray(r)))
    assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()


def test_cholesky_small_pivot_floor_matches_jax():
    """A rank-deficient (and a slightly indefinite) matrix: the pivot floor
    keeps the factor finite, as in JAX; the n > 32 refusal."""
    v = np.array([1.0, 2.0, 3.0])
    h = np.stack([np.outer(v, v), np.diag([1.0, -1e-20, 2.0])])
    got = cholesky_small(torch.from_numpy(h)).numpy()
    want = np.asarray(jax_cholesky_small(jnp.asarray(h)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="n=33"):
        cholesky_small(torch.eye(33))


def test_jdiag_hermitian_contract_and_jax_parity(rng):
    a = _psd(rng, 6, 5)
    b = _psd(rng, 6, 5)
    reg = 1e-9
    u, d = jdiag_hermitian(torch.from_numpy(a), torch.from_numpy(b), reg)
    u, d = u.numpy(), d.numpy()
    assert d.dtype == np.float64 and np.all(np.diff(d, axis=-1) <= 1e-12)
    uh = np.conj(np.swapaxes(u, 1, 2))
    np.testing.assert_allclose(uh @ (b + reg * np.eye(5)) @ u, np.broadcast_to(np.eye(5), u.shape),
                               atol=1e-10)
    np.testing.assert_allclose(uh @ a @ u, d[:, None, :] * np.eye(5), atol=1e-8 * np.abs(d).max())
    ju, jd = jax_jdiag_hermitian_batched(jnp.asarray(a), jnp.asarray(b), reg)
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-9, atol=0)
    # The phase-free projectors u_i u_i^H.
    proj = np.einsum("bij,bkj->bjik", u, u.conj())
    jproj = np.einsum("bij,bkj->bjik", np.asarray(ju), np.asarray(ju).conj())
    assert np.abs(proj - jproj).max() <= 1e-9 * np.abs(jproj).max()
    # A non-finite pencil gives NaNs, as in JAX (torch would raise).
    a_bad = a.copy()
    a_bad[2, 0, 0] = np.nan
    u, d = jdiag_hermitian(torch.from_numpy(a_bad), torch.from_numpy(b), reg)
    assert torch.isnan(d[2]).all() and torch.isfinite(d[[0, 1, 3, 4, 5]]).all()


def test_jdiag_hermitian_batched_jacobi_filters_match_jax(rng):
    """The 'jacobi' branch (cholesky_small, whitening, K7's plain version,
    back-substitution) keeps U^H B U = I and gives JAX's per-rank filters
    cumsum((u_i^H r) / (d_i + mu) u_i)."""
    n, bz, sweeps = 8, 7, 10
    a = _psd(rng, bz, n).astype(np.complex64)
    b = (_psd(rng, bz, n) + 0.1 * np.eye(n)).astype(np.complex64)
    r = (rng.standard_normal((bz, n)) + 1j * rng.standard_normal((bz, n))).astype(np.complex64)
    u, d = jdiag_hermitian_batched(torch.from_numpy(a), torch.from_numpy(b), 0.0, "jacobi", sweeps)
    ju, jd = jax_jdiag_hermitian_batched(jnp.asarray(a), jnp.asarray(b), 0.0, eigh_impl="jacobi",
                                         jacobi_sweeps=sweeps, interpret=True)
    u, d, ju, jd = u.numpy(), d.numpy(), np.asarray(ju), np.asarray(jd)
    uh = np.conj(np.swapaxes(u, 1, 2)).astype(np.complex128)
    gram = uh @ b.astype(np.complex128) @ u
    assert np.abs(gram - np.eye(n)).max() <= 5e-4
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5 * np.abs(jd).max())

    def filters(u, d):
        coef = np.einsum("bsi,bs->bi", u.conj(), r) / (d + 1.0)
        return np.cumsum(coef[:, :, None] * np.swapaxes(u, 1, 2), axis=1)

    fw, fj = filters(u, d), filters(ju, jd)
    assert np.abs(fw - fj).max() <= 1e-4 * np.abs(fj).max()
    ul, dl = jdiag_hermitian_batched(torch.from_numpy(a), torch.from_numpy(b), 0.0, "lapack")
    np.testing.assert_allclose(d, dl.numpy(), rtol=0, atol=2e-4 * np.abs(dl.numpy()).max())


def test_eigh_when_the_solver_fails(monkeypatch):
    """torch raises for a whole batch where an eigensolver does not
    converge. The port's ``eigh`` solves such a batch again in double
    precision (cuSOLVER's single-precision solver fails on nearly scalar
    matrices that LAPACK solves) and rounds back; a matrix on which that
    fails too is filled with NaNs, as JAX fills an element whose info is
    not 0."""
    # The module (the package exports the function jdiag under its name).
    jdiag = importlib.import_module("apvast_torch.ops.jdiag")

    solve = torch.linalg.eigh

    def single_fails(x):
        if x.dtype == torch.complex64:
            raise torch.linalg.LinAlgError("did not converge")
        return solve(x)

    def one_fails(x):
        if x.dim() == 3 or float(x[0, 0].real) == 5.0:
            raise torch.linalg.LinAlgError("did not converge")
        return solve(x)

    h = torch.eye(3, dtype=torch.complex64).repeat(3, 1, 1)
    h[1, 0, 0] = 5.0
    h[2, 0, 1], h[2, 1, 0] = 1e-9j, -1e-9j
    want = solve(h.to(torch.complex128))
    monkeypatch.setattr(torch.linalg, "eigh", single_fails)
    d, v = jdiag.eigh(h)
    assert d.dtype == torch.float32 and v.dtype == torch.complex64
    torch.testing.assert_close(d, want[0].float(), rtol=0, atol=0)
    torch.testing.assert_close(v, want[1].to(torch.complex64), rtol=0, atol=0)
    monkeypatch.setattr(torch.linalg, "eigh", one_fails)
    d, v = jdiag.eigh(h)
    assert torch.isnan(d[1]).all() and torch.isnan(v[1]).all()
    assert torch.isfinite(d[[0, 2]]).all() and torch.isfinite(v[[0, 2]]).all()
    torch.testing.assert_close(d[0], torch.ones(3), rtol=0, atol=1e-6)
