"""The tracking solver's Rayleigh-Ritz solve on its projected pencil, and
the Ritz coordinates after its small eigensolve.

Kernel: ``apvast_torch/csrc/tracked_rr.cu``, which replaces no Pallas
kernel: the JAX package leaves this chain of ``ops/jdiag.py::
jdiag_topk_tracked`` to XLA. In torch it is ~300 small launches a hop on
(2k, 2k) matrices; the kernel runs it as one block per zone (see its note).
Bound on the H100: latency, then one SM's fp32 FMA rate.

:func:`tracked_rr` takes the raw projections s^T A s and s^T B s (z, n, n)
of the tracker's basis s (z, JL, n), n = 2k, and returns ``(h, y, libar)``: the
symmetrized, jittered pencil's inverse Cholesky factor libar, the block y
of two CholeskyQR2 power steps on the whitened pencil wbar, and h =
sym(y^T wbar y), which K4 solves. :func:`tracked_rr_coords` forms the
pencil coordinates c = libar^T (y v[:, ::-1]) and lam = d[::-1] from K4's
ascending eigenpairs (d, v). On a CPU tensor each returns its plain version,
the torch chain it replaces; on the card the solve takes n <= ``MAX_WIDTH``
and 2k <= n. A zone whose input is not finite, or whose pencil or Gram
factorization meets a pivot that is not > 0 (where ``cholesky_ex`` reports
``info > 0`` and the chain fills NaN), comes back NaN in every entry of h,
y and libar, as the chain's does downstream.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _batch, _build
from apvast_torch.ops.trisolve import cholesky, cholqr2, triangular_inverse

MAX_WIDTH = 128  # n = 2k on the card: one zone's solve in one block's shared memory


def _sym(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x + x.transpose(-1, -2))


def tracked_rr_plain(
    abar: torch.Tensor, bbar: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The torch chain of :func:`tracked_rr`, as the tracking solver ran it
    before the kernel: any dtype, any device, any k <= n."""
    abar = _sym(abar)
    bbar = _sym(bbar)
    kk = bbar.shape[-1]
    eyek = torch.eye(kk, dtype=bbar.dtype, device=bbar.device)
    tr = torch.diagonal(bbar, dim1=-2, dim2=-1).sum(-1) / kk
    # Trace-relative, dtype-scaled jitter: covers roundoff on warmup
    # hops without biasing float64 eigenvalues.
    jit_rel = 8.0 * torch.finfo(bbar.dtype).eps
    bbar = bbar + (jit_rel * tr)[:, None, None] * eyek
    lbar = cholesky(bbar)
    libar = triangular_inverse(lbar)
    wbar = _sym((libar @ abar) @ libar.transpose(-1, -2))
    # Inner inexact solve: k-block power steps seeded from the X
    # coordinates (the previous Ritz vectors span basis slots :k).
    y = cholqr2(lbar.transpose(-1, -2)[:, :, :k])
    for _ in range(2):
        y = cholqr2(wbar @ y)
    h = _sym(y.transpose(-1, -2) @ (wbar @ y))
    return h, y, libar


def tracked_rr(
    abar: torch.Tensor, bbar: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rayleigh-Ritz solve of the tracker's projected pencils.

    Args:
        abar, bbar: (z, n, n) float32 raw projections (symmetrized here).
        k: the block width; on the card 2k <= n <= ``MAX_WIDTH``.

    Returns:
        ``(h (z, k, k), y (z, n, k), libar (z, n, n))``.
    """
    if _batch.via_op(abar, bbar):
        return tracked_rr_op(abar, bbar, k)
    z, n, n2 = abar.shape
    if n != n2 or tuple(bbar.shape) != (z, n, n) or not 1 <= k <= n:
        raise ValueError(f"tracked_rr takes two (z, n, n) pencils and 1 <= k <= n, got "
                         f"{tuple(abar.shape)}, {tuple(bbar.shape)} and k = {k}")
    for name, t in (("abar", abar), ("bbar", bbar)):
        _build.check_input(t, name, 3, abar.device, cpu_float64=True)
    if abar.device.type == "cpu":
        return tracked_rr_plain(abar, bbar, k)
    if n > MAX_WIDTH or 2 * k > n:
        raise ValueError(f"tracked_rr on the card takes 2k <= n <= {MAX_WIDTH}, got n = {n}, "
                         f"k = {k}")
    h = abar.new_empty((z, k, k))
    y = abar.new_empty((z, n, k))
    libar = abar.new_empty((z, n, n))
    if z:
        _build.launch("tracked_rr", "tracked_rr_launch", abar, bbar, h, y, libar, z, n, k)
        tracked_rr.launches += 1
    return h, y, libar


tracked_rr.launches = 0
tracked_rr_op = _batch.fold(
    "tracked_rr", tracked_rr,
    fake=lambda abar, bbar, k: (abar.new_empty((abar.shape[0], k, k)),
                                abar.new_empty((*abar.shape[:2], k)), abar.new_empty(abar.shape)),
)


def tracked_rr_coords_plain(
    libar: torch.Tensor, y: torch.Tensor, d: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The torch form of :func:`tracked_rr_coords`."""
    return libar.transpose(-1, -2) @ (y @ v.flip(-1)), d.flip(-1)


def tracked_rr_coords(
    libar: torch.Tensor, y: torch.Tensor, d: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pencil coordinates of the Ritz vectors, descending.

    Args:
        libar: (z, n, n) float32 lower triangular, :func:`tracked_rr`'s.
        y: (z, n, k) float32, :func:`tracked_rr`'s.
        d, v: (z, k) and (z, k, k) float32 ascending eigenpairs of h, as K4
            (or ``eigh``, whose v may be column-major) returns them.

    Returns:
        ``(c (z, n, k), lam (z, k))``: c = libar^T (y v[:, ::-1]), lam =
        d[::-1].
    """
    if _batch.via_op(libar, y, d, v):
        return tracked_rr_coords_op(libar, y, d, v)
    z, n, k = y.shape
    if (tuple(libar.shape) != (z, n, n) or tuple(d.shape) != (z, k)
            or tuple(v.shape) != (z, k, k)):
        raise ValueError(f"tracked_rr_coords takes libar (z, n, n), y (z, n, k), d (z, k) and "
                         f"v (z, k, k), got {tuple(libar.shape)}, {tuple(y.shape)}, "
                         f"{tuple(d.shape)} and {tuple(v.shape)}")
    if libar.device.type == "cpu":
        # The chain's own layouts (triangular_inverse's and eigh's column-
        # major results) go to the plain version as they are.
        return tracked_rr_coords_plain(libar, y, d, v)
    d, v = d.contiguous(), v.contiguous()
    for name, t, ndim in (("libar", libar, 3), ("y", y, 3), ("d", d, 2), ("v", v, 3)):
        _build.check_input(t, name, ndim, libar.device)
    if n > MAX_WIDTH:
        raise ValueError(f"tracked_rr_coords on the card takes n <= {MAX_WIDTH}, got {n}")
    c = y.new_empty((z, n, k))
    lam = d.new_empty((z, k))
    if z and k:
        _build.launch("tracked_rr", "tracked_rr_coords_launch", libar, y, d, v, c, lam, z, n, k)
        tracked_rr_coords.launches += 1
    return c, lam


tracked_rr_coords.launches = 0
tracked_rr_coords_op = _batch.fold(
    "tracked_rr_coords", tracked_rr_coords,
    fake=lambda libar, y, d, v: (y.new_empty(y.shape), d.new_empty(d.shape)),
)
