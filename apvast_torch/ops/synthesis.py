"""Variable-span trade-off filter synthesis (port of
``apvast_tpu/ops/synthesis.py::variable_span_filters``): every rank-1..V
filter of a zone from one scaled cumulative sum over eigenvectors."""

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
