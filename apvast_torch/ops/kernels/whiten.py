"""K10a: Cholesky factor and inverse of 128 x 128 SPD panels, and the
blocked Cholesky that runs it once per panel.

Kernel: ``apvast_torch/csrc/whiten.cu``, replacing
``apvast_tpu/ops/pallas/whiten.py::chol_panel_pallas``. The 'invert'
subspace solver with ``use_pallas_whiten`` factors its two loaded dark
matrices with :func:`blocked_cholesky` (``whiten.py::blocked_cholesky``):
identity padding to a multiple of 128, one panel launch per 128 columns (7
at JL = 800), each panel solve refined once, and the trailing updates as
``torch.matmul``, as JAX leaves them to XLA. Bound on the H100: latency
(see the kernel's note).
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _build
from apvast_torch.ops.trisolve import clamped_cholesky

PANEL = 128


def chol_panel_plain(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's column algorithms in torch: :func:`clamped_cholesky`,
    then forward substitution for the inverse. Shapes as
    :func:`chol_panel`."""
    bz, p, _ = d.shape
    l = clamped_cholesky(d)
    rhs = torch.eye(p, dtype=d.dtype, device=d.device).repeat(bz, 1, 1)
    x = torch.zeros_like(d)
    for i in range(p):
        xi = rhs[:, i, : i + 1] / l[:, i, i, None]
        x[:, i, : i + 1] = xi
        rhs[:, i + 1 :, : i + 1] -= l[:, i + 1 :, i, None] * xi[:, None, :]
    return l, x


def chol_panel(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cholesky factors and their inverses of a (bz, 128, 128) SPD float32
    batch (its lower triangle is read). Returns ``(l, l_inv)``, both lower
    triangular; a non-PD panel gives non-finite values."""
    _build.check_input(d, "d", 3)
    if tuple(d.shape[-2:]) != (PANEL, PANEL):
        raise ValueError(f"panel kernel is fixed at {PANEL}")
    if d.device.type == "cpu":
        return chol_panel_plain(d)
    l = torch.empty_like(d)
    inv = torch.empty_like(d)
    if d.shape[0]:
        _build.launch("whiten", "chol_panel_launch", d, l, inv, d.shape[0])
        chol_panel.launches += 1
    return l, inv


chol_panel.launches = 0


def blocked_cholesky(b: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (bz, n, n) SPD float32 batch (loading
    applied): panel factorizations by :func:`chol_panel`, explicit-inverse
    panel solves with one refinement step, trailing updates as matmuls.
    Same contract as ``torch.linalg.cholesky``; a failed panel gives
    non-finite values instead of an error."""
    bz, n, _ = b.shape
    if b.dtype != torch.float32:
        raise ValueError("blocked_cholesky is a float32 path")
    npad = -(-n // PANEL) * PANEL
    if npad != n:
        # chol(blkdiag(B, I)) = blkdiag(chol(B), I).
        padded = torch.zeros((bz, npad, npad), dtype=b.dtype, device=b.device)
        padded[:, :n, :n] = b
        padded[:, n:, n:] = torch.eye(npad - n, dtype=b.dtype, device=b.device)
        b = padded
    out = torch.zeros((bz, npad, npad), dtype=b.dtype, device=b.device)
    trail = b
    for lo in range(0, npad, PANEL):
        hi = lo + PANEL
        lp, lpinv = chol_panel(trail[:, :PANEL, :PANEL].contiguous())
        out[:, lo:hi, lo:hi] = lp
        if hi < npad:
            a21 = trail[:, PANEL:, :PANEL]
            lpinv_t = lpinv.transpose(-1, -2)
            l21 = a21 @ lpinv_t
            # One refinement step of the panel solve L21 Lp^T = A21.
            l21 = l21 + (a21 - l21 @ lp.transpose(-1, -2)) @ lpinv_t
            trail = trail[:, PANEL:, PANEL:] - l21 @ l21.transpose(-1, -2)
            out[:, hi:, lo:hi] = l21
    return out[:, :n, :n]
