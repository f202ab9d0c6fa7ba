"""Joint diagonalization of a symmetric-PSD pencil (A, B) — the exact
solver (port of ``apvast_tpu/ops/jdiag.py::jdiag`` / ``jdiag_batched``;
``jdiag`` here is batched over any leading axes, so it is both).

Whiten with the Cholesky factor of the loaded B, take the symmetric
eigendecomposition, back-transform:
    U^T A U = diag(d)   with d descending,   U^T B U = I.
"""

from __future__ import annotations

import torch


def jdiag(A: torch.Tensor, B: torch.Tensor, reg: float = 1e-7):
    """Returns ``(U, d)``: generalized eigenvectors in the columns of U and
    eigenvalues in descending order. ``reg`` loads B's diagonal before the
    factorization.

    A factorization that fails (B + reg I not positive definite) yields
    NaNs, as the JAX solver's does, so the hop's ``silenced`` count sees it;
    ``torch.linalg.cholesky`` would raise instead.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    chol, info = torch.linalg.cholesky_ex(B + reg * eye)
    chol = torch.where((info > 0)[..., None, None], torch.nan, chol)
    half = torch.linalg.solve_triangular(chol, A, upper=False)
    white = torch.linalg.solve_triangular(
        chol, half.transpose(-1, -2), upper=False
    ).transpose(-1, -2)
    white = 0.5 * (white + white.transpose(-1, -2))
    d, v = torch.linalg.eigh(white)  # ascending
    u = torch.linalg.solve_triangular(
        chol.transpose(-1, -2), v.flip(-1), upper=True
    )
    return u, d.flip(-1)
