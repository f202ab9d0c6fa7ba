"""Batched tiny Cholesky for thousands of small pencils (port of
``apvast_tpu/ops/small_chol.py``).

The FD engine factorizes (2 * bins, S * B, S * B) Hermitian PD matrices
per hop. The JAX package unrolls a right-looking Cholesky over the small
matrix dimension (n rank-1 updates, each vectorized over the batch) with a
trace-relative pivot floor; the port keeps that algorithm, so a rounding-
induced non-PD pivot gives a large finite column, as in JAX, where
``torch.linalg.cholesky`` would raise or ``cholesky_ex`` give NaNs.
"""

from __future__ import annotations

import torch

# The unrolled program's size limit in JAX; the engine's use is S*B <= 32.
_MAX_UNROLL = 32


def cholesky_small(h: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of batched tiny Hermitian PD
    matrices ``h`` (..., n, n), n <= 32, real or complex. Each pivot is
    clamped to eps * max(mean diagonal, tiny); entries above the diagonal
    are exactly zero."""
    n = h.shape[-1]
    if n > _MAX_UNROLL:
        raise ValueError(
            f"cholesky_small unrolls the matrix dimension: n={n} > "
            f"{_MAX_UNROLL} belongs on jnp.linalg.cholesky"
        )
    rows = torch.arange(n, device=h.device)
    tr = torch.diagonal(h, dim1=-2, dim2=-1).sum(-1).real / n
    info = torch.finfo(tr.dtype)
    floor = tr.clamp_min(info.tiny) * info.eps
    a = h
    cols = []
    for k in range(n):
        pivot = torch.sqrt(torch.maximum(a[..., k, k].real, floor))
        col = a[..., :, k] / pivot.to(a.dtype)[..., None]
        # Rows above k of the running Schur complement are stale.
        col = torch.where(rows >= k, col, torch.zeros_like(col))
        cols.append(col)
        if k + 1 < n:
            a = a - col[..., :, None] * col[..., None, :].conj()
    return torch.stack(cols, dim=-1)


def posdef_solve_small(h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve h x = r for batched tiny Hermitian PD ``h`` (..., n, n) and
    ``r`` (..., n, m): :func:`cholesky_small` of the Hermitian part, then
    two triangular solves."""
    chol = cholesky_small(0.5 * (h + h.conj().transpose(-1, -2)))
    y = torch.linalg.solve_triangular(chol, r, upper=False)
    return torch.linalg.solve_triangular(chol.conj().transpose(-1, -2), y, upper=True)
