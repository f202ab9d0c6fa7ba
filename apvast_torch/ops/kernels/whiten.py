"""K10a: Cholesky factor and inverse of 128 x 128 SPD panels, and the
blocked Cholesky that runs it once per panel. K10b: the fused Cholesky
and triangular inverse of a whole SPD batch.

Kernel: ``apvast_torch/csrc/whiten.cu``, replacing
``apvast_tpu/ops/pallas/whiten.py::chol_panel_pallas``. The 'invert'
subspace solver with ``use_pallas_whiten`` factors its two loaded dark
matrices with :func:`blocked_cholesky` (``whiten.py::blocked_cholesky``):
identity padding to a multiple of 128, one panel launch per 128 columns (7
at JL = 800), each panel solve refined once, and the trailing updates as
``torch.matmul``, as JAX leaves them to XLA. Bound on the H100: latency
(see the kernel's note). The panel is factored and inverted in 32-wide
sub-panels by warps (``csrc/chol_warp.cuh``, shared with K9), whose torch
form is :func:`blocked_chol_inverse`.

K10b, :func:`chol_tri_inverse` (kernel ``apvast_torch/csrc/chol_tri_inverse.cu``,
replacing ``whiten.py::chol_tri_inverse_pallas``), returns ``L^-1`` of a
(bz, n, n) SPD batch with n <= 1024 after padding to a multiple of 128. No
engine path of either package calls it: the JAX package's
``whiten_kernel`` runs :func:`blocked_cholesky` instead
(``apvast_tpu/ops/jdiag.py:279-292``).
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _batch, _build
from apvast_torch.ops.trisolve import clamped_cholesky, neumann_tri_inverse

PANEL = 128
SUB = 32  # the sub-panel width of K10a's and K10b's panel factorizations
MAX_PADDED = 1024  # K10b's bound on n after padding, the JAX function's


def blocked_chol_inverse(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of ``csrc/chol_warp.cuh`` in torch: the lower Cholesky
    factor L of a (bz, n, n) SPD batch (n = 32, 64 or 128; the lower
    triangle is read) and X = L^-1, both with exact zeros above the
    diagonal. 32-wide sub-panels: each is factored by the column algorithm
    of :func:`clamped_cholesky` (pivot ``rsqrt(max(p, 1e-30))``) over all
    the rows below it, the trailing lower triangle takes its outer product,
    its diagonal block is inverted by forward substitution (each row's sum
    times the reciprocal of its diagonal entry), and the merge
    tree ``X21 = -X22 (L21 X11)`` (``whiten.py::_merge_tri``) joins the
    diagonal inverses. K10a computes this on a panel, K9 on each padded
    Gram matrix of its CholeskyQR2."""
    bz, n, _ = d.shape
    if n not in (SUB, 2 * SUB, 4 * SUB):
        raise ValueError(f"blocked_chol_inverse takes n = 32, 64 or 128, got {n}")
    a = torch.tril(d)
    l = torch.zeros_like(d)
    x = torch.zeros_like(d)
    for c0 in range(0, n, SUB):
        c1 = c0 + SUB
        for c in range(c0, c1):
            col = a[:, c:, c] * torch.rsqrt(a[:, c, c].clamp_min(1e-30))[:, None]
            l[:, c:, c] = col
            a[:, c + 1 :, c + 1 : c1] -= col[:, 1:, None] * col[:, None, 1 : c1 - c]
        if c1 < n:
            strip = l[:, c1:, c0:c1]
            a[:, c1:, c1:] -= torch.tril(strip @ strip.transpose(-1, -2))
        diag = l[:, c0:c1, c0:c1]
        for i in range(SUB):
            rhs = torch.zeros_like(diag[:, i, : i + 1])
            rhs[:, i] = 1.0
            terms = diag[:, i, :i, None] * x[:, c0 : c0 + i, c0 : c0 + i + 1]
            rhs -= torch.where(_lower(i, i + 1, d.device), terms, 0.0).sum(-2)
            x[:, c0 + i, c0 : c0 + i + 1] = rhs * (1.0 / diag[:, i, i, None])
    w = SUB
    while w < n:
        for lo in range(0, n, 2 * w):
            mid, hi = lo + w, lo + 2 * w
            t = _tri_matmul(l[:, mid:hi, lo:mid], x[:, lo:mid, lo:mid], lower_q=True)
            x[:, mid:hi, lo:mid] = -_tri_matmul(x[:, mid:hi, mid:hi], t, lower_q=False)
        w *= 2
    return l, x


def _lower(rows: int, cols: int, device) -> torch.Tensor:
    """The (rows, cols) mask row >= column."""
    return torch.ones(rows, cols, dtype=torch.bool, device=device).tril()


def _tri_matmul(p: torch.Tensor, q: torch.Tensor, lower_q: bool) -> torch.Tensor:
    """p @ q over the nonzero range of its triangular operand only (q lower:
    terms with l >= column; else p lower: l <= row), so that a non-finite
    entry of the other operand meets none of its structural zeros."""
    m = p.shape[-1]
    mask = (_lower(m, q.shape[-1], p.device) if lower_q
            else _lower(p.shape[-2], m, p.device))
    terms = p[..., :, :, None] * q[..., None, :, :]  # (.., row, l, column)
    keep = mask[None, :, :] if lower_q else mask[:, :, None]
    return torch.where(keep, terms, 0.0).sum(-2)


# K10a's plain version: the kernel's algorithm in torch.
chol_panel_plain = blocked_chol_inverse


def chol_panel(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cholesky factors and their inverses of a (bz, 128, 128) SPD float32
    batch (its lower triangle is read). Returns ``(l, l_inv)``, both lower
    triangular; a non-PD panel gives non-finite values."""
    if _batch.via_op(d):
        return chol_panel_op(d)
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
chol_panel_op = _batch.fold(
    "chol_panel", chol_panel, fake=lambda d: (d.new_empty(d.shape), d.new_empty(d.shape))
)


def blocked_cholesky(b: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a (bz, n, n) SPD float32 batch (loading
    applied): panel factorizations by :func:`chol_panel`, explicit-inverse
    panel solves with one refinement step, trailing updates as matmuls.
    Same contract as ``torch.linalg.cholesky``; a failed panel gives
    non-finite values instead of an error. Writes no tensor in place, so
    that ``torch.func.vmap`` passes (the factor is joined from its panel
    columns)."""
    bz, n, _ = b.shape
    if b.dtype != torch.float32:
        raise ValueError("blocked_cholesky is a float32 path")
    npad = -(-n // PANEL) * PANEL
    trail = _pad_identity(b, npad)
    columns = []
    for lo in range(0, npad, PANEL):
        hi = lo + PANEL
        lp, lpinv = chol_panel(trail[:, :PANEL, :PANEL].contiguous())
        column = lp
        if hi < npad:
            a21 = trail[:, PANEL:, :PANEL]
            lpinv_t = lpinv.transpose(-1, -2)
            l21 = a21 @ lpinv_t
            # One refinement step of the panel solve L21 Lp^T = A21.
            l21 = l21 + (a21 - l21 @ lp.transpose(-1, -2)) @ lpinv_t
            trail = trail[:, PANEL:, PANEL:] - l21 @ l21.transpose(-1, -2)
            column = torch.cat([lp, l21], dim=-2)
        columns.append(torch.nn.functional.pad(column, (0, 0, lo, 0)))
    return torch.cat(columns, dim=-1)[:, :n, :n]


def _pad_identity(b: torch.Tensor, npad: int) -> torch.Tensor:
    """blkdiag(b, I) of size npad: chol(blkdiag(B, I)) = blkdiag(chol(B), I)."""
    bz, n, _ = b.shape
    if npad == n:
        return b
    eye = torch.eye(npad - n, dtype=b.dtype, device=b.device)
    top = torch.nn.functional.pad(b, (0, npad - n))
    bottom = torch.nn.functional.pad(eye, (n, 0)).expand(bz, npad - n, npad)
    return torch.cat([top, bottom], dim=-2)


def _merge(x11: torch.Tensor, x22: torch.Tensor, l21: torch.Tensor) -> torch.Tensor:
    """The inverse of [[L11, 0], [L21, L22]] from X11 = L11^-1 and X22 =
    L22^-1: X21 = -X22 (L21 X11)."""
    top = torch.cat([x11, torch.zeros_like(x11)], -1)
    bot = torch.cat([-(x22 @ (l21 @ x11)), x22], -1)
    return torch.cat([top, bot], -2)


def _panel_factor(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor and inverse of (bz, 128, 128) SPD diagonal blocks (lower
    triangle read), as K10b's panel step: 32-wide sub-panels by
    :func:`clamped_cholesky`, each inverted by :func:`neumann_tri_inverse`
    (the TPU kernel's ``_neumann_inv_sub``: exact doubling, two Newton
    steps; a non-finite sub-panel fills its whole 32 x 32 inverse), the
    sub-panel solve below it by its explicit inverse with one refinement
    step, the in-panel trailing update, then the merge tree of
    ``whiten.py::_merge_tri`` for the panel inverse."""
    d = torch.tril(d)
    lp = torch.zeros_like(d)
    invs = []
    for g0 in range(0, PANEL, SUB):
        g1 = g0 + SUB
        ls = clamped_cholesky(d[:, g0:g1, g0:g1])
        inv_s = neumann_tri_inverse(ls)
        invs.append(inv_s)
        lp[:, g0:g1, g0:g1] = ls
        if g1 < PANEL:
            a21 = d[:, g1:, g0:g1]
            inv_t = inv_s.transpose(-1, -2)
            l21 = a21 @ inv_t
            l21 = l21 + (a21 - l21 @ ls.transpose(-1, -2)) @ inv_t
            lp[:, g1:, g0:g1] = l21
            d[:, g1:, g1:] -= torch.tril(l21 @ l21.transpose(-1, -2))
    x01 = _merge(invs[0], invs[1], lp[:, SUB : 2 * SUB, :SUB])
    x23 = _merge(invs[2], invs[3], lp[:, 3 * SUB :, 2 * SUB : 3 * SUB])
    return lp, _merge(x01, x23, lp[:, 2 * SUB :, : 2 * SUB])


def _check_chol_tri_inverse(b: torch.Tensor) -> int:
    """Raise on what K10b does not take; return the padded size."""
    if not isinstance(b, torch.Tensor) or b.dtype != torch.float32:
        raise ValueError(
            f"chol_tri_inverse is a float32 kernel, got {getattr(b, 'dtype', type(b))}"
        )
    _build.check_input(b, "b", 3)
    bz, n, n2 = b.shape
    if n != n2 or n < 1:
        raise ValueError(f"b must be a batch of square matrices, got {tuple(b.shape)}")
    npad = -(-n // PANEL) * PANEL
    if npad > MAX_PADDED:
        raise ValueError(
            f"n={n} pads to {npad} > {MAX_PADDED}: K10b's bound (the JAX kernel's "
            "VMEM-resident limit); use cholesky + triangular_inverse"
        )
    return npad


def chol_tri_inverse_plain(b: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in torch: identity padding, the right-looking
    blocked Cholesky of :func:`_panel_factor` panels with explicit-inverse
    panel solves refined once and the block-lower trailing updates, and the
    block-row substitution ``X_p = -Lp^-1 (L[p, :p] X[:p, :p])`` refined
    once, ``x += Lp^-1 (-s - Lp x)``. Shapes as :func:`chol_tri_inverse`."""
    npad = _check_chol_tri_inverse(b)
    n = b.shape[-1]
    a = _pad_identity(b, npad).clone()
    l = torch.zeros_like(a)
    x = torch.zeros_like(a)
    for lo in range(0, npad, PANEL):
        hi = lo + PANEL
        lp, lpinv = _panel_factor(a[:, lo:hi, lo:hi])
        l[:, lo:hi, lo:hi] = lp
        if hi < npad:
            a21 = a[:, hi:, lo:hi]
            inv_t = lpinv.transpose(-1, -2)
            l21 = a21 @ inv_t
            l21 = l21 + (a21 - l21 @ lp.transpose(-1, -2)) @ inv_t
            l[:, hi:, lo:hi] = l21
            a[:, hi:, hi:] -= l21 @ l21.transpose(-1, -2)
        x[:, lo:hi, lo:hi] = lpinv
        if lo:
            s = l[:, lo:hi, :lo] @ x[:, :lo, :lo]
            xi = -(lpinv @ s)
            xi = xi + lpinv @ (-s - lp @ xi)
            x[:, lo:hi, :lo] = xi
    return torch.tril(x[:, :n, :n]).contiguous()


def chol_tri_inverse(b: torch.Tensor) -> torch.Tensor:
    """Lower-triangular inverse Cholesky factors of an SPD float32 batch.

    Args:
        b: (bz, n, n) SPD, loading applied (its lower triangle is read);
            n <= 1024 after padding to a multiple of 128.

    Returns:
        (bz, n, n) ``L^-1`` with ``L L^T = b``, exact zeros above the
        diagonal: the contract of ``triangular_inverse(cholesky(b))``. A
        non-PD matrix gives non-finite values (the pivot rule
        ``rsqrt(max(pivot, 1e-30))``), not an error.
    """
    npad = _check_chol_tri_inverse(b)
    if b.device.type == "cpu":
        return chol_tri_inverse_plain(b)
    bz, n, _ = b.shape
    out = torch.empty_like(b)
    if bz:
        ws = torch.empty(chol_tri_inverse_workspace_floats(bz, npad), dtype=torch.float32,
                         device=b.device)
        _build.launch("chol_tri_inverse", "chol_tri_inverse_launch", b, out, ws, bz, n, npad)
        chol_tri_inverse.launches += 1
    return out


chol_tri_inverse.launches = 0

# The kernel's ready counters a matrix, and those of a launch
# (csrc/chol_tri_inverse.cu: kCounters, kGlobalCounters).
K10B_COUNTERS, K10B_GLOBAL_COUNTERS = 1024, 32


def chol_tri_inverse_workspace_floats(bz: int, npad: int) -> int:
    """Floats of K10b's workspace (csrc/chol_tri_inverse.cu's layout): per
    matrix the trailing matrix and L, and X = L^-1, then the ready
    counters, which the launch zeroes."""
    return 2 * bz * npad * npad + K10B_GLOBAL_COUNTERS + bz * K10B_COUNTERS
