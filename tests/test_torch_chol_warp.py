"""The blocked factor-and-inverse algorithm of K10a and K9
(``csrc/chol_warp.cuh``), in its torch form
``apvast_torch.ops.kernels.whiten.blocked_chol_inverse``, against the
column algorithms it replaces (``clamped_cholesky`` and the Neumann inverse
of ``neumann_tri_inverse``, or forward substitution) and against float64;
and K9's schedule, written out in torch with that factorization and the
second pass's L^-T folded into the next product, against K9's plain
version (the TPU kernel's algorithm).

Tolerances: float32 sums in another order, 1e-5 of scale against the
column algorithms and K9's plain version; against a float64 oracle at most
twice the float32 column algorithms' own error (``TOL_ORACLE_RATIO``, as
``chip_smoke.py`` holds the kernels on the card).
"""

import numpy as np
import pytest
import torch

from apvast_torch.ops.kernels.subspace import subspace_iterate_plain
from apvast_torch.ops.kernels.whiten import blocked_chol_inverse
from apvast_torch.ops.trisolve import clamped_cholesky, neumann_tri_inverse
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL_ORACLE_RATIO = 2.0


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _spd(seed, bz, n, boost=0.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((bz, n, n)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32)
    if boost:
        spd[0] += boost * np.outer(a[0, 0], a[0, 0]) / n
    return torch.from_numpy(spd)


def _column_inverse(l):
    """Forward substitution against the identity, row by row: the first
    design's inverse."""
    n = l.shape[-1]
    x = torch.zeros_like(l)
    rhs = torch.eye(n, dtype=l.dtype).repeat(l.shape[0], 1, 1)
    for i in range(n):
        xi = rhs[:, i, : i + 1] / l[:, i, i, None]
        x[:, i, : i + 1] = xi
        rhs[:, i + 1 :, : i + 1] -= l[:, i + 1 :, i, None] * xi[:, None, :]
    return x


def _padded_gram(seed, k, n=200, jitter_rel=1e-6):
    """A CholeskyQR2 Gram matrix of k columns, jittered as K9 jitters it,
    and its identity padding to the kernel's width (32, 64 or 128)."""
    y = torch.from_numpy(np.random.default_rng(seed).standard_normal((2, n, k)).astype(np.float32))
    g = y.transpose(1, 2) @ y
    trace = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    g = g + (jitter_rel * trace / k + 1e-30)[:, None, None] * torch.eye(k)
    kp = 32 if k <= 32 else 64 if k <= 64 else 128
    pad = torch.eye(kp).repeat(2, 1, 1)
    pad[:, :k, :k] = g
    return g, pad


@pytest.mark.parametrize("n", [32, 64, 128])
def test_blocked_chol_inverse_matches_column_algorithms_and_float64(n):
    d = _spd(n, 3, n)
    l, x = blocked_chol_inverse(d)
    l_ref = clamped_cholesky(d)
    for x_ref in (neumann_tri_inverse(l_ref), _column_inverse(l_ref)):
        assert _rel(x, x_ref) <= 1e-5
    assert _rel(l, l_ref) <= 1e-5
    assert torch.equal(torch.triu(l, 1), torch.zeros_like(l))
    assert torch.equal(torch.triu(x, 1), torch.zeros_like(x))
    l64 = torch.linalg.cholesky(d.double())
    x64 = torch.linalg.inv(l64)
    assert _rel(l, l64) <= TOL_ORACLE_RATIO * _rel(l_ref, l64)
    assert _rel(x, x64) <= TOL_ORACLE_RATIO * _rel(neumann_tri_inverse(l_ref), x64)


@pytest.mark.parametrize("k", [8, 24, 64, 112])
def test_blocked_chol_inverse_of_k9_padded_grams(k):
    """K9's factorization: the jittered Gram padded with the identity gives
    blkdiag(L, I) and blkdiag(L^-1, I); L^-1 within the Neumann inverse's
    rounding and twice its error against float64."""
    g, pad = _padded_gram(k, k)
    l, x = blocked_chol_inverse(pad)
    kp = pad.shape[-1]
    assert torch.equal(l[:, k:, k:], torch.eye(kp - k).repeat(2, 1, 1))
    assert torch.equal(x[:, k:, :], torch.eye(kp)[k:].repeat(2, 1, 1))
    x_ref = neumann_tri_inverse(clamped_cholesky(g))
    assert _rel(x[:, :k, :k], x_ref) <= 1e-5
    x64 = torch.linalg.inv(torch.linalg.cholesky(g.double()))
    assert _rel(x[:, :k, :k], x64) <= TOL_ORACLE_RATIO * _rel(x_ref, x64)


def test_blocked_chol_inverse_non_pd_and_nan_as_the_column_algorithms():
    """A negative pivot (matrix 1) and a NaN below the diagonal (matrix 2)
    give the column algorithms' pattern of non-finite values in L and in
    X; the SPD matrix beside them stays finite."""
    d = _spd(5, 3, 128)
    d[1, 70, 70] = -1.0
    d[2, 90, 20] = float("nan")
    l, x = blocked_chol_inverse(d)
    l_ref = clamped_cholesky(d)
    x_ref = _column_inverse(l_ref)
    assert torch.isfinite(l[0]).all() and torch.isfinite(x[0]).all()
    assert not torch.isfinite(l[1]).all() and not torch.isfinite(x[1]).all()
    assert torch.isfinite(l[1, :70]).all() and torch.isfinite(x[1, :70]).all()
    assert torch.equal(torch.isnan(l[2]), torch.isnan(l_ref[2]))
    assert torch.equal(torch.isnan(x[2]), torch.isnan(x_ref[2]))
    assert torch.isnan(x[2]).any() and torch.isfinite(x[2, :90]).all()


def test_blocked_chol_inverse_refuses_other_widths():
    with pytest.raises(ValueError, match="32, 64 or 128"):
        blocked_chol_inverse(torch.eye(96)[None])


def _k9_schedule(a, li, q0, iters, jitter_rel=1e-6):
    """K9's schedule in torch: each Gram's L^-T from the padded blocked
    factorization; the second pass's L^-T applied after the next Li^T
    product, (Li^T y) W, and q = y W written where it is an output."""
    k = q0.shape[-1]

    def w_of(y):
        g = y.transpose(1, 2) @ y
        trace = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        g = g + (jitter_rel * trace / k + 1e-30)[:, None, None] * torch.eye(k)
        kp = 32 if k <= 32 else 64 if k <= 64 else 128
        pad = torch.eye(kp).repeat(g.shape[0], 1, 1)
        pad[:, :k, :k] = g
        return blocked_chol_inverse(pad)[1][:, :k, :k].transpose(1, 2)

    x, w = q0, None
    for _ in range(iters):
        t1 = li.transpose(1, 2) @ x if w is None else (li.transpose(1, 2) @ x) @ w
        y = li @ (a @ t1)
        y = y @ w_of(y)
        x, w = y, w_of(y)
    q = x if w is None else x @ w
    t1 = li.transpose(1, 2) @ x if w is None else (li.transpose(1, 2) @ x) @ w
    small = q.transpose(1, 2) @ (li @ (a @ t1))
    return q, 0.5 * (small + small.transpose(1, 2))


@pytest.mark.parametrize("n,k,iters", [(96, 16, 2), (50, 8, 1), (40, 16, 0), (200, 24, 2),
                                       (120, 112, 2)])
def test_k9_schedule_matches_plain_and_float64(n, k, iters):
    rng = np.random.default_rng(n + k)

    def spd(bz):
        x = rng.standard_normal((bz, n, n)).astype(np.float32)
        return torch.from_numpy(x @ x.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32))

    a = spd(2)
    li = torch.linalg.inv(torch.linalg.cholesky(spd(2).double())).float().tril()
    q0 = torch.from_numpy(rng.standard_normal((2, n, k)).astype(np.float32))
    got = _k9_schedule(a, li, q0, iters)
    want = subspace_iterate_plain(a, li, q0, iters)
    oracle = subspace_iterate_plain(a.double(), li.double(), q0.double(), iters)
    for x, w, o in zip(got, want, oracle):
        assert _rel(x, w) <= 1e-5
        assert _rel(x, o) <= TOL_ORACLE_RATIO * max(_rel(w, o), 1e-7)
