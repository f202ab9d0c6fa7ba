"""The tracking solver's small symmetric eigensolver, cyclic parallel
Jacobi, in the precision of its input (float64 here): a frozen copy of the
formula that the port's kernel K4 and the JAX package's ``jacobi_eigh``
state, so that the reference stops after as many sweeps as the
configuration does (two in production, far from converged, so the result
depends on the rotation order, which this copy keeps): the padding to
``max(8, ceil8(n))`` slots, the round-robin tournament schedule, the angle
formula with its sign rule and ``1e-30`` guard, ``c = 1/sqrt(1 + t^2)``,
one rotation-permutation matrix a round, and the ascending ranking with pad
slots last and the first index winning ties.
"""

from __future__ import annotations

import numpy as np
import torch


def padded_size(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def tournament_schedule(n: int) -> np.ndarray:
    """src[slot]: the slot whose occupant moves into ``slot`` each round.
    Slots pair as (2i, 2i + 1); slot 0 stays and the others walk a ring, so
    n - 1 rounds meet every pair once."""
    m = n // 2
    ring = [2 * i for i in range(1, m)] + [2 * i + 1 for i in range(m - 1, -1, -1)]
    src = np.arange(n)
    for p in range(len(ring)):
        src[ring[(p + 1) % len(ring)]] = ring[p]
    return src


def jacobi_eigh(a: torch.Tensor, sweeps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(w (B, n) ascending, v (B, n, n)) of the symmetric (B, n, n) ``a``
    after ``sweeps`` Jacobi sweeps of n_pad - 1 rounds each."""
    bz, n, _ = a.shape
    npad = padded_size(n)
    dev, dt = a.device, a.dtype
    a = torch.nn.functional.pad(a, (0, npad - n, 0, npad - n))
    src = torch.as_tensor(tournament_schedule(npad), device=dev)
    rows = torch.arange(npad, device=dev)[:, None]
    perm_d = (src[None, :] == rows).to(dt)
    perm_u = ((src[None, :] == rows + 1) & (rows % 2 == 0)).to(dt)
    perm_l = ((src[None, :] == rows - 1) & (rows % 2 == 1)).to(dt)
    even = (torch.arange(npad, device=dev) % 2 == 0).to(dt)
    v = torch.eye(npad, dtype=dt, device=dev).expand(bz, npad, npad)
    for _ in range(sweeps * (npad - 1)):
        diag = torch.diagonal(a, dim1=-2, dim2=-1)
        apq = a[:, 0::2, 1::2].diagonal(dim1=-2, dim2=-1)
        apq = torch.stack([apq, torch.zeros_like(apq)], -1).reshape(bz, npad)
        theta = torch.roll(diag, -1, dims=-1) - diag
        sg = torch.where(theta >= 0, 1.0, -1.0).to(dt)
        t = 2.0 * apq * sg / (theta.abs() + torch.sqrt(theta * theta + 4.0 * apq * apq) + 1e-30)
        c = torch.rsqrt(1.0 + t * t)
        s_e, c_e = t * c * even, c * even
        s2 = (s_e + torch.roll(s_e, 1, dims=-1))[..., None]
        c2 = (c_e + torch.roll(c_e, 1, dims=-1))[..., None]
        m = perm_d * c2 + perm_u * s2 - perm_l * s2
        a = m.transpose(-1, -2) @ (a @ m)
        v = v @ m
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    idx = torch.arange(npad, device=dev)
    keyed = torch.where(idx < n, w, torch.full_like(w, float("inf")))
    ki, kj = keyed[:, :, None], keyed[:, None, :]
    rank = ((kj < ki) | ((kj == ki) & (idx[None, :] < idx[:, None])[None])).sum(-1)
    perm = (rank[:, :, None] == torch.arange(n, device=dev)).to(dt)
    return torch.einsum("bi,bic->bc", w, perm), (v @ perm)[:, :n, :]
