"""Offline (non-adaptive, non-perceptual) VAST, the "VAST 2018" baseline
(port of ``apvast_tpu/models/vast_offline.py``).

With mu = 1 the span endpoints of one design reproduce the classic
baselines: ``num_eigenvectors = 1`` is BACC (acoustic contrast control)
and ``num_eigenvectors = filter_length * num_srcs`` is pressure matching.

The reference excites the room with a unit impulse and accumulates the
statistics through a sliding convolution matrix over ``num_steps`` time
steps. The accumulated data vectors are lagged reads of the RIRs,

    y_{n,m}[s*J + r] = g[m, n - r, s]   (zero outside the RIR support),

so the RIRs are framed once (a strided view of the zero-padded RIRs) and
the (mics, JL, steps) tensor is contracted in one product. The reference's
``num_steps`` truncation (it clips correlation lags when ``num_steps <
rir_length + J - 1``) is kept.

The entry points take RIRs as NumPy arrays or tensors, laid out
``(rir_length, num_srcs, num_mics)``, and run in their dtype on ``device``
(``"cuda"`` unless the caller asks for another).
"""

from __future__ import annotations

import torch

from apvast_torch.ops.jdiag import jdiag
from apvast_torch.ops.synthesis import (
    variable_span_filters,
    variable_span_filters_mu_grid,
)
from apvast_torch.utils.device import resolve_device


def _lagged_rir_frames(rir: torch.Tensor, filter_length: int, num_steps: int) -> torch.Tensor:
    """Frame RIRs (rir_length, srcs, mics) into the offline data tensor
    y (mics, srcs * J, num_steps), y[m, s*J + r, n] = rir[n - r, s, m]."""
    j = filter_length
    rl, s, m = rir.shape
    # Time last, front-padded by J - 1 (negative lags) and back-padded so
    # every step n <= num_steps - 1 is in range.
    g = rir.permute(2, 1, 0)  # (m, s, rl)
    back = max(0, num_steps - rl - (j - 1)) + j
    g = torch.nn.functional.pad(g, (j - 1, back))
    # windows[..., n, i] = g[..., n + i]; tap r reads i = J - 1 - r.
    frames = g.unfold(-1, j, 1)[:, :, :num_steps].flip(-1)  # (m, s, n, j)
    return frames.transpose(-1, -2).reshape(m, s * j, num_steps)


def _as_rirs(rir_bright, rir_dark, device):
    device = resolve_device(device)
    rb = torch.as_tensor(rir_bright).to(device)
    return rb, torch.as_tensor(rir_dark).to(device=device, dtype=rb.dtype)


def vast_statistics(
    rir_bright,
    rir_dark,
    filter_length: int,
    modeling_delay: int,
    reference_index: int,
    num_steps: int = 1000,
    device: str | torch.device | None = None,
):
    """(R_bright, R_dark, r_bright) of the offline design, normalized by
    ``mics * (rir_length - filter_length)`` as the reference does."""
    rir_bright, rir_dark = _as_rirs(rir_bright, rir_dark, device)
    rl, _, m = rir_bright.shape
    yb = _lagged_rir_frames(rir_bright, filter_length, num_steps)
    yd = _lagged_rir_frames(rir_dark, filter_length, num_steps)
    # Target d[m, n]: the reference speaker's bright RIR delayed by the
    # modeling delay, truncated to the RIR length (nonzero only for
    # modeling_delay <= n < rir_length).
    d = torch.zeros((m, num_steps), dtype=rir_bright.dtype, device=rir_bright.device)
    span = max(0, min(num_steps, rl) - modeling_delay)
    d[:, modeling_delay : modeling_delay + span] = rir_bright[:span, reference_index, :].T
    rb = torch.einsum("man,mbn->ab", yb, yb)
    rd = torch.einsum("man,mbn->ab", yd, yd)
    rvec = torch.einsum("man,mn->a", yb, d)
    scale = 1.0 / (m * (rl - filter_length))
    return rb * scale, rd * scale, rvec * scale


def vast_offline(
    rir_bright,
    rir_dark,
    filter_length: int,
    modeling_delay: int,
    reference_index: int,
    num_eigenvectors: int,
    mu: float,
    num_steps: int = 1000,
    reg: float = 0.0,
    return_family: bool = False,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """One-shot VAST design from RIRs alone: the FIR filters
    (filter_length, num_srcs); with ``return_family=True`` every span
    (V, filter_length, num_srcs)."""
    rb, rd, rvec = vast_statistics(rir_bright, rir_dark, filter_length, modeling_delay,
                                   reference_index, num_steps, device)
    u, lam = jdiag(rb, rd, reg)
    family = variable_span_filters(u, lam, rvec, mu, num_eigenvectors)
    s = rvec.shape[0] // filter_length
    # (V, JL) source-major -> (V, J, S), the reference's layout.
    family = family.reshape(num_eigenvectors, s, filter_length).transpose(1, 2)
    return family if return_family else family[-1]


def acc(
    rir_bright,
    rir_dark,
    filter_length: int,
    modeling_delay: int,
    reference_index: int,
    num_steps: int = 1000,
    reg: float = 0.0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """The BACC (acoustic contrast control) endpoint: the rank-1 span with
    mu = 1."""
    return vast_offline(rir_bright, rir_dark, filter_length, modeling_delay, reference_index,
                        num_eigenvectors=1, mu=1.0, num_steps=num_steps, reg=reg,
                        device=device)


def pressure_matching(
    rir_bright,
    rir_dark,
    filter_length: int,
    modeling_delay: int,
    reference_index: int,
    num_steps: int = 1000,
    reg: float = 0.0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """The pressure-matching endpoint: the full-rank span with mu = 1."""
    full_rank = filter_length * torch.as_tensor(rir_bright).shape[1]
    return vast_offline(rir_bright, rir_dark, filter_length, modeling_delay, reference_index,
                        num_eigenvectors=full_rank, mu=1.0, num_steps=num_steps, reg=reg,
                        device=device)


def vast_offline_sweep(
    rir_bright,
    rir_dark,
    filter_length: int,
    modeling_delay: int,
    reference_index: int,
    num_eigenvectors: int,
    mu_grid,
    num_steps: int = 1000,
    reg: float = 0.0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """The (mu x span-rank) design surface from one GEVD: (len(mu_grid), V,
    filter_length, num_srcs). The BACC endpoint is [:, 0] at mu = 1,
    pressure matching [:, -1] at full rank."""
    rb, rd, rvec = vast_statistics(rir_bright, rir_dark, filter_length, modeling_delay,
                                   reference_index, num_steps, device)
    u, lam = jdiag(rb, rd, reg)
    mu_grid = torch.as_tensor(mu_grid).to(device=rvec.device, dtype=rvec.dtype)
    surface = variable_span_filters_mu_grid(u, lam, rvec, mu_grid, num_eigenvectors)
    s = rvec.shape[0] // filter_length
    return surface.reshape(len(mu_grid), num_eigenvectors, s, filter_length).transpose(2, 3)
