"""Joint diagonalization of a symmetric-PSD pencil (A, B) (port of
``apvast_tpu/ops/jdiag.py``): the exact solver ``jdiag`` (batched over any
leading axes) and ``jdiag_batched`` (a (z, n, n) stack), the round-3
subspace solvers ``jdiag_topk_batched`` ('invert'/'solve' whitening, with
kernels K9 and K10a) and ``jdiag_topk_pencil_batched`` ('newton'), and the
production tracking solver ``jdiag_topk_tracked``, with their CholeskyQR2
``_cholqr2``; and the frequency-domain engine's complex Hermitian
``jdiag_hermitian`` and ``jdiag_hermitian_batched`` (``torch.linalg.eigh``,
or kernel K7).

Contract of both:
    U^T A U = diag(d)   with d descending,   U^T B U = I.

Every matmul here is a plain fp32 (or fp64) product: the JAX solver asks
for ``Precision.HIGH``/``HIGHEST`` on the TPU, which on the card means
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
default). The one exception is the tracking solver's residual path under
``residual_precision="default"`` (:func:`single_pass_matmul`).
"""

from __future__ import annotations

import torch

from apvast_torch.observability import meter
from apvast_torch.ops.kernels import (
    blocked_cholesky,
    jacobi_eigh,
    jacobi_eigh_hermitian,
    subspace_iterate,
    tracked_rr,
    tracked_rr_coords,
    tracked_rr_coords_plain,
    tracked_rr_plain,
)
from apvast_torch.ops.kernels.tracked_rr import MAX_WIDTH as TRACKED_RR_WIDTH
from apvast_torch.ops.small_chol import cholesky_small
from apvast_torch.ops.trisolve import cholesky, neumann_tri_inverse, triangular_inverse
from apvast_torch.ops.trisolve import cholqr2 as _cholqr2

_meter = meter()


def eigh(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` (ascending) that returns NaNs for a matrix
    with a non-finite entry, or one no solver converges on, as JAX's does
    (it fills an element whose LAPACK or cuSOLVER info is not 0); torch
    raises instead. cuSOLVER's single-precision solver also fails on
    nearly scalar matrices (a loaded diagonal with couplings many orders
    smaller, as the FD group solve meets at bins without statistics) that
    LAPACK solves, so a batch that fails is solved again in double
    precision and rounded back, and element by element where that fails."""
    bad = ~torch.isfinite(h).all(-1).all(-1)
    x = torch.where(bad[..., None, None], torch.zeros_like(h), h)
    try:
        d, v = torch.linalg.eigh(x)
    except torch.linalg.LinAlgError:
        d, v, failed = _eigh_wide(x)
        bad = bad | failed
    return d.masked_fill(bad[..., None], torch.nan), v.masked_fill(bad[..., None, None], torch.nan)


def _eigh_wide(x: torch.Tensor):
    """Eigenpairs of ``x`` computed in double precision (rounded back to
    ``x``'s dtype), and a mask of the matrices on which that fails too."""
    wide = torch.complex128 if x.is_complex() else torch.float64
    real = x.real.dtype
    try:
        d, v = torch.linalg.eigh(x.to(wide))
        return d.to(real), v.to(x.dtype), torch.zeros(x.shape[:-2], dtype=torch.bool,
                                                       device=x.device)
    except torch.linalg.LinAlgError:
        pass
    flat = x.reshape(-1, *x.shape[-2:])
    d = torch.zeros(flat.shape[:-1], dtype=real, device=x.device)
    v = torch.zeros_like(flat)
    failed = torch.zeros(flat.shape[0], dtype=torch.bool, device=x.device)
    for i in range(flat.shape[0]):
        try:
            di, vi = torch.linalg.eigh(flat[i].to(wide))
            d[i], v[i] = di.to(real), vi.to(x.dtype)
        except torch.linalg.LinAlgError:
            failed[i] = True
    return d.reshape(x.shape[:-1]), v.reshape(x.shape), failed.reshape(x.shape[:-2])


def jdiag(A: torch.Tensor, B: torch.Tensor, reg: float = 1e-7):
    """Returns ``(U, d)``: generalized eigenvectors in the columns of U and
    eigenvalues in descending order. ``reg`` loads B's diagonal before the
    factorization."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    chol = cholesky(B + reg * eye)
    half = torch.linalg.solve_triangular(chol, A, upper=False)
    white = torch.linalg.solve_triangular(
        chol, half.transpose(-1, -2), upper=False
    ).transpose(-1, -2)
    white = 0.5 * (white + white.transpose(-1, -2))
    d, v = eigh(white)  # ascending
    u = torch.linalg.solve_triangular(
        chol.transpose(-1, -2), v.flip(-1), upper=True
    )
    return u, d.flip(-1)


def jdiag_batched(A: torch.Tensor, B: torch.Tensor, reg: float = 1e-7):
    """:func:`jdiag` of a (z, n, n) batch of pencils (both zones, frames,
    subbands or grid points in one call), ``reg`` shared by all. Returns
    ``(U (z, n, n), d (z, n))``."""
    if A.dim() != 3 or B.shape != A.shape:
        raise ValueError(f"jdiag_batched takes two (z, n, n) stacks, got {tuple(A.shape)} "
                         f"and {tuple(B.shape)}")
    return jdiag(A, B, reg)


def _sym(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (x + x.transpose(-1, -2))


def _orthonormalizer(orth: str):
    """CholeskyQR2 for "cholqr2", Householder QR for any other value."""
    if orth == "cholqr2":
        return _cholqr2
    return lambda q: torch.linalg.qr(q)[0]


def _small_eigh(h: torch.Tensor, small_eigh: str, jacobi_sweeps: int):
    """Ascending eigenpairs of the small Rayleigh-Ritz matrices: kernel K4
    for "jacobi", else ``eigh``."""
    if small_eigh == "jacobi":
        return jacobi_eigh(h.contiguous(), jacobi_sweeps)
    return eigh(h)


def _topk_project(A, B, reg, iters, q_init, orth, whiten, li_pre=None):
    """Subspace-iteration front half of :func:`jdiag_topk_batched`, batched
    over the leading pencil axis: whitening setup, ``iters`` power steps
    on the whitened operator, and the small Rayleigh-Ritz projection.
    Returns ``(small, q, wmat)`` with ``wmat`` the inverse Cholesky factor
    ('invert') or the Cholesky factor (any other whitening: 'solve').
    ``li_pre`` is a precomputed inverse Cholesky factor for 'invert'."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    if whiten == "invert":
        li = li_pre if li_pre is not None else triangular_inverse(cholesky(B + reg * eye))
        li_t = li.transpose(-1, -2)

        def apply_white(x):
            return li @ (A @ (li_t @ x))

        wmat = li
    else:
        # The whitened operator L^-1 A L^-T applied implicitly: triangular
        # solves against the k-column subspace only.
        chol = cholesky(B + reg * eye)
        chol_t = chol.transpose(-1, -2)

        def apply_white(x):
            y = torch.linalg.solve_triangular(chol_t, x, upper=True)
            return torch.linalg.solve_triangular(chol, A @ y, upper=False)

        wmat = chol
    orthonormalize = _orthonormalizer(orth)
    q = q_init
    for _ in range(iters):
        q = orthonormalize(apply_white(q))
    small = q.transpose(-1, -2) @ apply_white(q)
    return _sym(small), q, wmat


def _topk_extract(small_d, small_v, q, wmat, num_vectors, q_init, whiten):
    """Ritz extraction and back-transform, back half of
    :func:`jdiag_topk_batched`; ``small_d``/``small_v`` are the ASCENDING
    eigenpairs of the projected matrices. Returns ``(u, d, ritz,
    silenced)``: non-finite entries of u and d are zeroed and counted,
    and a non-finite carry entry falls back to ``q_init``'s."""
    d = small_d.flip(-1)[..., :num_vectors]
    ritz = q @ small_v.flip(-1)
    if whiten == "invert":
        u = wmat.transpose(-1, -2) @ ritz[..., :num_vectors]
    else:
        u = torch.linalg.solve_triangular(
            wmat.transpose(-1, -2), ritz[..., :num_vectors], upper=True
        )
    bad_u = ~torch.isfinite(u)
    bad_d = ~torch.isfinite(d)
    silenced = bad_u.sum(dtype=torch.int32) + bad_d.sum(dtype=torch.int32)
    ritz = torch.where(torch.isfinite(ritz), ritz, q_init)
    u = torch.where(bad_u, torch.zeros_like(u), u)
    d = torch.where(bad_d, torch.zeros_like(d), d)
    return u, d, ritz, silenced


def jdiag_topk_batched(
    A: torch.Tensor,
    B: torch.Tensor,
    reg: float,
    num_vectors: int,
    iters: int,
    q_init: torch.Tensor,
    orth: str = "qr",
    whiten: str = "solve",
    small_eigh: str = "lapack",
    jacobi_sweeps: int = 4,
    fused_iteration: bool = False,
    whiten_kernel: bool = False,
):
    """Top-k generalized eigenpairs of a (z, n, n) pencil batch by blocked
    subspace iteration, warm-started from ``q_init`` (z, n, k).

    ``whiten_kernel`` ('invert' only, float32) factors the loaded dark
    matrices with :func:`blocked_cholesky` (kernel K10a per panel).
    ``fused_iteration`` runs the power steps, CholeskyQR2 and the
    Rayleigh-Ritz projection as kernel K9; it requires whiten='invert' and
    orth='cholqr2'. ``small_eigh="jacobi"`` solves the projections with K4.

    Returns ``(u, d, q, silenced)``: u (z, n, num_vectors) and d descending,
    the carry, and the count of non-finite outputs zeroed (int32).
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    li_pre = None
    if whiten_kernel and whiten == "invert":
        li_pre = triangular_inverse(blocked_cholesky(B + reg * eye))
    if fused_iteration:
        if whiten != "invert" or orth != "cholqr2":
            raise ValueError("fused_iteration requires whiten='invert', orth='cholqr2'")
        wmat = li_pre if li_pre is not None else triangular_inverse(cholesky(B + reg * eye))
        q, small = subspace_iterate(
            A.contiguous(), wmat.contiguous(), q_init.contiguous(), iters
        )
    else:
        small, q, wmat = _topk_project(A, B, reg, iters, q_init, orth, whiten, li_pre)
    d, v = _small_eigh(small, small_eigh, jacobi_sweeps)
    return _topk_extract(d, v, q, wmat, num_vectors, q_init, whiten)


def jdiag_topk(A, B, reg, num_vectors, iters, q_init, orth="qr", whiten="solve"):
    """One pencil of :func:`jdiag_topk_batched` (LAPACK Rayleigh-Ritz, no
    kernels). Returns ``(u, d, q)``."""
    u, d, q, _ = jdiag_topk_batched(
        A[None], B[None], reg, num_vectors, iters, q_init[None], orth, whiten
    )
    return u[0], d[0], q[0]


def _basis_healthy(q: torch.Tensor) -> torch.Tensor:
    """Per batch element: all finite and no column underflowed to zero (a
    zero warm start is absorbing)."""
    fin = torch.isfinite(q).all(dim=-1).all(dim=-1)
    cn = (q * q).sum(-2).min(-1).values
    return fin & (cn > 1e-20)


def jdiag_topk_pencil_batched(
    A: torch.Tensor,
    B: torch.Tensor,
    reg: float,
    num_vectors: int,
    iters: int,
    q_init: torch.Tensor,
    m_init: torch.Tensor,
    orth: str = "cholqr2",
    small_eigh: str = "lapack",
    jacobi_sweeps: int = 4,
    newton_steps: int = 1,
    resid_max: float = 0.7,
    select: bool = False,
):
    """Top-k GEVD with a carried approximate inverse M ~ (B + reg I)^-1
    ('newton' whitening) in place of a per-hop Cholesky.

    M is refreshed by ``newton_steps`` Newton-Schulz steps
    M <- M (2I - B M) while the worst Frobenius residual ||I - B M|| of the
    batch (the pencils of one scene) stays below ``resid_max``, and rebuilt
    from a fresh Cholesky otherwise (cold start, onsets, a non-finite M).
    JAX takes that decision on the device with ``lax.cond``. Here it is a
    host bool (one device read per hop), so only the branch taken runs;
    with ``select`` both branches run and ``torch.where`` takes M by the
    decision, which stays on the device: the form that runs under
    ``torch.func.vmap`` over scenes, one decision a scene, as JAX's vmapped
    ``lax.cond`` lowers to a select. The subspace iterates on M A, and the
    small problem is the projected pencil (q^T A q, q^T B q).

    Returns ``(u, d, q_next, m_next, silenced, rebuilt)``; ``rebuilt`` is
    a host bool, or with ``select`` a bool tensor.
    """
    z, n, _ = A.shape
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    b_l = B + reg * eye
    resid = eye - b_l @ m_init
    worst = torch.sqrt(resid.square().sum((-2, -1))).max()
    healthy = torch.isfinite(worst) & (worst < resid_max)

    def refreshed():
        m = m_init + m_init @ resid
        for _ in range(newton_steps - 1):
            m = m + m @ (eye - b_l @ m)
        return m

    def rebuilt_inverse():
        li = triangular_inverse(cholesky(b_l))
        return li.transpose(-1, -2) @ li

    if select:
        m = torch.where(healthy, refreshed(), rebuilt_inverse())
        rebuilt = ~healthy
    else:
        rebuilt = not bool(healthy)
        m = rebuilt_inverse() if rebuilt else refreshed()
    m = _sym(m)

    orthonormalize = _orthonormalizer(orth)
    q = q_init
    for _ in range(iters):
        q = orthonormalize(m @ (A @ q))

    # Pencil Rayleigh-Ritz on the exact A, B.
    k = q.shape[-1]
    qt = q.transpose(-1, -2)
    abar = _sym(qt @ (A @ q))
    bbar = _sym(qt @ (b_l @ q))
    eyek = torch.eye(k, dtype=A.dtype, device=A.device)
    # Trace-relative, dtype-scaled jitter: bbar is PD in exact arithmetic.
    tr = torch.diagonal(bbar, dim1=-2, dim2=-1).sum(-1) / k
    jit_rel = 8.0 * torch.finfo(A.dtype).eps
    lib = neumann_tri_inverse(cholesky(bbar + (jit_rel * tr)[:, None, None] * eyek))
    white = _sym((lib @ abar) @ lib.transpose(-1, -2))
    d, v = _small_eigh(white, small_eigh, jacobi_sweeps)
    ubar = lib.transpose(-1, -2) @ v
    d_desc = d.flip(-1)[..., :num_vectors]
    u = q @ ubar.flip(-1)[..., :num_vectors]
    # Carry: the Ritz-rotated (euclidean-orthonormal) subspace, descending.
    ritz = q @ v.flip(-1)

    bad_u = ~torch.isfinite(u)
    bad_d = ~torch.isfinite(d_desc)
    silenced = bad_u.sum(dtype=torch.int32) + bad_d.sum(dtype=torch.int32)
    ritz = torch.where(torch.isfinite(ritz), ritz, q_init)
    # Zone-wise degeneracy guard: a zone whose carry underflowed to zero
    # restarts from q_init, or from identity columns if q_init is bad too.
    eye_nk = eye[:, :k].expand_as(ritz)
    fallback = torch.where(_basis_healthy(q_init)[:, None, None], q_init, eye_nk)
    ritz = torch.where(_basis_healthy(ritz)[:, None, None], ritz, fallback)
    u = torch.where(bad_u, torch.zeros_like(u), u)
    d_desc = torch.where(bad_d, torch.zeros_like(d_desc), d_desc)
    # A non-finite M self-heals: its residual forces the next rebuild.
    return u, d_desc, ritz, m, silenced, rebuilt


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest, ties to even) and widened back
    to its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def single_pass_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the TPU's single-pass (``Precision.DEFAULT``) matmul
    computes it: both operands rounded to bfloat16, whose products are
    exact in float32, summed in float32, the result float32 (not rounded
    back). A float32 matmul on the rounded operands is that arithmetic on
    the CPU and on the card alike (TF32 off)."""
    return bf16_round(a.float()) @ bf16_round(b.float())


def _rr_kernel_takes(s: torch.Tensor) -> bool:
    """Whether the tracker's Rayleigh-Ritz solve on the basis ``s`` (z, n,
    2k) runs as its kernel: a float32 CUDA basis of at most
    ``TRACKED_RR_WIDTH`` columns; anything else runs the torch chain."""
    return (s.device.type == "cuda" and s.dtype == torch.float32
            and s.shape[-1] <= TRACKED_RR_WIDTH)


def jdiag_topk_tracked(
    A: torch.Tensor,
    B: torch.Tensor,
    reg: float,
    num_vectors: int,
    q_init: torch.Tensor,
    lam_init: torch.Tensor,
    li_carry: torch.Tensor,
    rebuild: bool,
    outer_steps: int = 2,
    small_eigh: str = "lapack",
    jacobi_sweeps: int = 4,
    rr_basis: str = "cholqr2",
    half_form: bool = False,
    residual_precision: str = "high",
):
    """Top-k GEVD by inner-outer subspace tracking, with no (n, n)
    factorization except when ``rebuild`` is set.

    The carried inverse Cholesky factor Li preconditions each outer step:
    the carried Ritz basis X (z, n, k) is expanded with the block residual
    P = Li^T Li (A X - B X L), and the doubled pencil on [X, P] is solved
    by Rayleigh-Ritz on the exact (A, B): whitened by its own small
    Cholesky factor, two k-block power steps seeded from the X coordinates,
    then one (k, k) eigensolve (kernel K4 for ``small_eigh="jacobi"``).

    ``half_form``: A and B are half matrices M with the pencil R = M + M^T
    (the skew statistics' half form); R x is applied as M x + M^T x and the
    full dark matrix exists only for the rebuild's Cholesky.

    ``rebuild`` is a host bool: the factorization runs only on the hops
    that refresh Li, and a non-finite fresh factor falls back to the
    carried one. The hop meter's ``factor`` mark follows it on every hop,
    before any other work of the solver. The carry may be bfloat16
    (``tracking_li_bf16``): the fresh factor is rounded to it, and its
    products promote it back to the pencil's dtype, as ``jnp.matmul`` of
    bfloat16 and float32 does.

    ``residual_precision="default"``: the residual path's products (A X
    and B X, and P's two products with Li) take bfloat16-rounded operands
    (:func:`single_pass_matmul`); they only steer the basis expansion,
    whose Rayleigh-Ritz matrices are recomputed at full precision, but
    with ``rr_basis="direct"`` A X and B X are reused in them, as in JAX.

    Returns ``(u, d, q_next, lam_next, li_next, silenced, resid_rel)``:
    u (z, n, num_vectors) with U^T (B + reg I) U = I, d descending, the
    carries, the count of non-finite outputs zeroed (int32) and the
    relative block residual of the incoming Ritz pairs on this pencil
    (float32 scalar, max over zones, +inf when non-finite or when a zone's
    basis was degenerate), which the caller compares with its rebuild
    threshold on the next hop.
    """
    z, n, _ = A.shape
    k = q_init.shape[-1]
    dtype, dev = A.dtype, A.device
    eye = torch.eye(n, dtype=dtype, device=dev)

    def mm(a, b, single_pass=False):
        return single_pass_matmul(a, b) if single_pass else a @ b

    if half_form:
        def apply_a(x, sp=False):
            return mm(A, x, sp) + mm(A.transpose(-1, -2), x, sp)

        def apply_b(x, sp=False):
            return mm(B, x, sp) + mm(B.transpose(-1, -2), x, sp) + reg * x

        def b_full():
            return B + B.transpose(-1, -2) + reg * eye
    else:
        b_l = B + reg * eye

        def apply_a(x, sp=False):
            return mm(A, x, sp)

        def apply_b(x, sp=False):
            return mm(b_l, x, sp)

        def b_full():
            return b_l

    li = li_carry
    if rebuild:
        fresh = triangular_inverse(cholesky(b_full())).to(li_carry.dtype)
        li = torch.where(torch.isfinite(fresh), fresh, li_carry)
    _meter.mark("factor")

    # Zone-wise basis-health guard: a sustained true-silence gap collapses
    # the pencil until the inner CholeskyQR2 returns an exactly-zero
    # (finite) basis, which is absorbing (its residual reads 0, below any
    # rebuild threshold). A basis is healthy iff all-finite and no column
    # has underflowed; unhealthy zones restart from identity columns.
    eye_nk = eye[:, :k].expand(z, n, k)
    healthy0 = _basis_healthy(q_init)
    q_init = torch.where(healthy0[:, None, None], q_init, eye_nk)
    lam_init = torch.where(healthy0[:, None], lam_init, torch.zeros_like(lam_init))
    li_w = li.to(dtype)  # exact: bfloat16 widens to float32 without rounding
    sp = residual_precision == "default"

    q, lam = q_init, lam_init
    resid_rel = None
    for _ in range(outer_steps):
        aq = apply_a(q, sp)
        bq = apply_b(q, sp)
        res = aq - bq * lam[:, None, :]
        if resid_rel is None:
            # Staleness of the incoming Ritz pairs, from products already
            # computed; a non-finite value maps to +inf (forces a rebuild).
            num = res.float().square().sum((-2, -1))
            den = aq.float().square().sum((-2, -1))
            resid_rel = torch.sqrt(num / (den + torch.finfo(torch.float32).tiny)).max()
            resid_rel = torch.where(
                torch.isfinite(resid_rel), resid_rel, torch.full_like(resid_rel, torch.inf)
            )
        p = mm(li_w.transpose(-1, -2), mm(li_w, res, sp), sp)
        if rr_basis == "direct":
            # Rayleigh-Ritz on the raw basis [q, p] (the whitening of bbar
            # below makes orthonormality unnecessary), reusing A q and B q;
            # p is column-scaled so bbar stays balanced.
            pn = torch.sqrt((p * p).sum(-2, keepdim=True))
            p = p / (pn + torch.finfo(dtype).tiny)
            s = torch.cat([q, p], dim=-1)
            a_s = torch.cat([aq, apply_a(p)], dim=-1)
            b_s = torch.cat([bq, apply_b(p)], dim=-1)
        else:
            s = _cholqr2(torch.cat([q, p], dim=-1))
            a_s = apply_a(s)
            b_s = apply_b(s)
        st = s.transpose(-1, -2)
        # The Rayleigh-Ritz solve on the projected pencil (whitening, the
        # power steps and their CholeskyQR2, h), then K4 on h, then the
        # pencil coordinates c (descending, c^T bbar c = I): on the card in
        # float32 up to 2k = 128 one launch each side of K4, else torch.
        solve, coords = ((tracked_rr, tracked_rr_coords) if _rr_kernel_takes(s)
                         else (tracked_rr_plain, tracked_rr_coords_plain))
        h, y, libar = solve(st @ a_s, st @ b_s, k)
        d, v = _small_eigh(h, small_eigh, jacobi_sweeps)  # ascending
        c, lam = coords(libar, y, d, v)
        q = s @ c  # B-orthonormal Ritz vectors

    u = q[..., :num_vectors]
    dd = lam[..., :num_vectors]
    bad_u = ~torch.isfinite(u)
    bad_d = ~torch.isfinite(dd)
    silenced = bad_u.sum(dtype=torch.int32) + bad_d.sum(dtype=torch.int32)
    u = torch.where(bad_u, torch.zeros_like(u), u)
    dd = torch.where(bad_d, torch.zeros_like(dd), dd)
    # Carries self-heal: non-finite entries fall back to the incoming
    # values, and a zone whose outgoing basis went degenerate falls back to
    # the sanitized entry basis. (Li is healed inside the rebuild.)
    q = torch.where(torch.isfinite(q), q, q_init)
    lam = torch.where(torch.isfinite(lam), lam, torch.zeros_like(lam))
    healthy1 = _basis_healthy(q)
    q = torch.where(healthy1[:, None, None], q, q_init)
    lam = torch.where(healthy1[:, None], lam, lam_init)
    # A degenerate hop must force the caller's rebuild: report +inf, not
    # the zero residual of a zero basis.
    resid_rel = torch.where(
        healthy0.all() & healthy1.all(), resid_rel, torch.full_like(resid_rel, torch.inf)
    )
    return u, dd, q, lam, li, silenced, resid_rel


def _whiten_hermitian(A, chol):
    """L^-1 A L^-H of batched Hermitian ``A``, made exactly Hermitian."""
    half = torch.linalg.solve_triangular(chol, A, upper=False)
    white = torch.linalg.solve_triangular(
        chol, half.conj().transpose(-1, -2), upper=False
    ).conj().transpose(-1, -2)
    return 0.5 * (white + white.conj().transpose(-1, -2))


def jdiag_hermitian(A: torch.Tensor, B: torch.Tensor, reg: float = 1e-7):
    """Joint diagonalization of complex Hermitian-PSD pencils (batched over
    any leading axes): ``U^H A U = diag(d)`` with d real and descending,
    ``U^H (B + reg I) U = I``. A failed factor or a non-finite pencil gives
    NaNs, as in JAX."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    chol = cholesky(B + reg * eye)
    d, v = eigh(_whiten_hermitian(A, chol))  # ascending
    u = torch.linalg.solve_triangular(chol.conj().transpose(-1, -2), v, upper=True)
    return u.flip(-1), d.flip(-1)


def jdiag_hermitian_batched(
    A: torch.Tensor,
    B: torch.Tensor,
    reg: float = 1e-7,
    eigh_impl: str = "lapack",
    jacobi_sweeps: int = 8,
):
    """:func:`jdiag_hermitian` over a leading pencil axis, the FD engine's
    per-bin GEVD. ``eigh_impl="lapack"`` is ``torch.linalg.eigh``;
    "jacobi" factors with :func:`cholesky_small` and solves the whitened
    matrices with kernel K7 (complex64 only)."""
    if eigh_impl == "lapack":
        return jdiag_hermitian(A, B, reg)
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    chol = cholesky_small(B + reg * eye)
    white = _whiten_hermitian(A, chol).contiguous()
    d, v = jacobi_eigh_hermitian(white, jacobi_sweeps)  # ascending
    u = torch.linalg.solve_triangular(chol.conj().transpose(-1, -2), v, upper=True)
    return u.flip(-1), d.flip(-1)
