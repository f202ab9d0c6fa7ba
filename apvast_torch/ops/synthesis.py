"""Variable-span trade-off filter synthesis (port of
``apvast_tpu/ops/synthesis.py``): every rank-1..V filter of a zone from one
scaled cumulative sum over eigenvectors, the (mu x rank) surface of a
sweep, and the selection of given spans."""

from __future__ import annotations

import torch


def variable_span_filters(
    u: torch.Tensor,
    eigenvalues: torch.Tensor,
    r: torch.Tensor,
    mu: float,
    num_eigenvectors: int,
) -> torch.Tensor:
    """All rank-1..V filters ``w[..., v] = sum_{i<=v} (u_i . r) /
    (lambda_i + mu) u_i``.

    ``u`` (..., JL, JL) eigenvector columns in descending order,
    ``eigenvalues`` (..., JL), ``r`` (..., JL); returns (..., V, JL).
    """
    v = num_eigenvectors
    ut = u[..., :, :v].transpose(-1, -2)  # (..., V, JL)
    coeffs = (ut @ r[..., None])[..., 0] / (eigenvalues[..., :v] + mu)  # (..., V)
    return torch.cumsum(coeffs[..., None] * ut, dim=-2)


def variable_span_filters_mu_grid(
    u: torch.Tensor,
    eigenvalues: torch.Tensor,
    r: torch.Tensor,
    mu_grid: torch.Tensor,
    num_eigenvectors: int,
) -> torch.Tensor:
    """The whole (mu x rank) filter surface from one eigendecomposition:
    mu enters only the per-eigenpair scaling. ``u`` (JL, JL),
    ``eigenvalues`` (JL,), ``r`` (JL,), ``mu_grid`` (G,); returns
    (G, V, JL)."""
    v = num_eigenvectors
    ut = u[:, :v].T  # (V, JL)
    proj = ut @ r  # (V,)
    coeffs = proj[None, :] / (eigenvalues[None, :v] + mu_grid[:, None])
    return torch.cumsum(coeffs[..., None] * ut[None], dim=1)


def spans_from_family(w_family: torch.Tensor, spans) -> torch.Tensor:
    """The filters of the given spans (eigenvector counts, the MATLAB
    multi-solution contract) out of a rank family (V, JL): (len(spans),
    JL)."""
    return w_family[[s - 1 for s in spans]]
