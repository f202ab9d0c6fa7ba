"""Triangular inversion (port of ``apvast_tpu/ops/trisolve.py``), and the
solvers' NaN-filled Cholesky factor and CholeskyQR2 that use it.

``neumann_tri_inverse`` is the matmul-only inverse of a small lower
factor, kept as written: CholeskyQR2 (:func:`cholqr2`, JAX's
``ops/jdiag._cholqr2``) uses it, and its zero-diagonal guard decides what a
collapsed (silent) pencil gives. :func:`cholesky` and :func:`cholqr2` live
here, below ``ops/jdiag.py``, so that the tracker's Rayleigh-Ritz kernel
(``ops/kernels/tracked_rr.py``), which ``ops/jdiag.py`` imports, can run
them in its plain version.
``clamped_cholesky`` is the column Cholesky of the TPU kernels K9 and K10a,
which their plain versions share. ``triangular_inverse`` inverts a large
Cholesky factor. The JAX function splits it into blocks to dodge the
TPU's latency-bound substitution; on the card one batched
``solve_triangular`` against the identity is the same inverse (the JAX
function's own path for blocks it cannot split).
"""

from __future__ import annotations

import torch


def neumann_tri_inverse(l: torch.Tensor, refine: int = 2) -> torch.Tensor:
    """Inverse of (batched) lower-triangular ``l`` by exact Neumann
    doubling: L = D (I - M) with M strictly lower and nilpotent, so
    (I - M)^-1 = prod_j (I + M^(2^j)); then ``refine`` Newton steps
    X <- X + X (I - L X)."""
    n = l.shape[-1]
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    d = torch.diagonal(l, dim1=-2, dim2=-1)
    # An exact-zero diagonal (semi-definite input) would give inf * 0 = NaN
    # in M; the guard keeps the result bounded.
    dinv = 1.0 / torch.where(d == 0, torch.ones_like(d), d)
    m = eye - dinv[..., :, None] * l
    x = eye + m
    p = m
    for _ in range(max(0, (n - 1).bit_length() - 1)):
        p = p @ p
        x = x + x @ p
    x = x * dinv[..., None, :]
    for _ in range(refine):
        x = x + x @ (eye - l @ x)
    return x


def clamped_cholesky(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (batched) ``g`` by the TPU kernels' column
    algorithm (``subspace.py::_chol_2d``, ``whiten.py::_chol_sub``): step c
    scales column c by ``rsqrt(max(pivot, 1e-30))`` and subtracts its outer
    product from the trailing matrix. Only the lower triangle of ``g`` is
    read. A pivot <= 0 scales its column by 1e15, so an indefinite ``g``
    gives a non-finite factor, where ``cholesky_ex`` would report it."""
    p = g.shape[-1]
    g = g.clone()
    l = torch.zeros_like(g)
    for c in range(p):
        isr = torch.rsqrt(g[..., c, c].clamp_min(1e-30))
        col = g[..., c:, c] * isr[..., None]
        l[..., c:, c] = col
        g[..., c + 1 :, c + 1 :] -= col[..., 1:, None] * col[..., None, 1:]
    return l


def triangular_inverse(chol: torch.Tensor) -> torch.Tensor:
    """Inverse of a (batched) lower-triangular matrix."""
    n = chol.shape[-1]
    eye = torch.eye(n, dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)


def cholesky(x: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN-filled where the factorization fails, as
    JAX's is (``torch.linalg.cholesky`` would raise instead), so the
    solvers' non-finite guards and ``silenced`` count see it."""
    chol, info = torch.linalg.cholesky_ex(x)
    return torch.where((info > 0)[..., None, None], torch.nan, chol)


def cholqr2(q: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2 orthonormalization of the columns of (batched) ``q``:
    two passes of q <- q L^-T with L the Cholesky factor of the Gram
    matrix, jittered relative to its own trace so a rank-deficient block
    does not turn the factor into NaNs."""
    k = q.shape[-1]
    eye = torch.eye(k, dtype=q.dtype, device=q.device)
    for _ in range(2):
        gram = q.transpose(-1, -2) @ q
        trace = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
        jitter = (trace / k) * 1e-6 + 1e-30
        chol = cholesky(gram + jitter[..., None, None] * eye)
        q = q @ neumann_tri_inverse(chol).transpose(-1, -2)
    return q
