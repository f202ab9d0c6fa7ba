"""K9: the fused subspace iteration of the 'invert' GEVD solver.

Kernel: ``apvast_torch/csrc/subspace.cu``, replacing
``apvast_tpu/ops/pallas/subspace.py::subspace_iterate_pallas``: ``iters``
whitened power steps, each followed by the kernel's own CholeskyQR2, and
the small Rayleigh-Ritz projection, in one cooperative launch per hop.
Bound on the H100: operations (see the kernel's note). The kernel factors
and inverts each jittered Gram matrix (identity-padded to 32, 64 or 128)
by :func:`~apvast_torch.ops.kernels.whiten.blocked_chol_inverse`'s
algorithm (``csrc/chol_warp.cuh``), which gives the L^-1 of the plain
version's Neumann doubling and Newton steps up to rounding.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _batch, _build
from apvast_torch.ops.trisolve import clamped_cholesky, neumann_tri_inverse

TILE_ROWS = 16  # output rows of a product tile in csrc/subspace.cu
MAX_WIDTH = 112  # the kernel's small factorizations fit in shared memory up to this k


def workspace_floats(bz: int, n: int, k: int) -> int:
    """Floats of the kernel's workspace: three (bz, n, k) operands, the
    (bz, ceil(n / 16), k, k) Gram partials and the (bz, k, k) Grams."""
    return 3 * bz * n * k + bz * -(-n // TILE_ROWS) * k * k + bz * k * k


def subspace_iterate_plain(
    a: torch.Tensor, li: torch.Tensor, q0: torch.Tensor, iters: int, jitter_rel: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel body (``subspace.py:96-127``) in torch: the Gram
    jitter ``jitter_rel * trace / k + 1e-30``, the clamped column Cholesky
    and the Neumann inverse with two Newton steps. Shapes as
    :func:`subspace_iterate`."""
    k = q0.shape[-1]
    eye = torch.eye(k, dtype=q0.dtype, device=q0.device)
    li_t = li.transpose(-1, -2)

    def apply_white(x):
        return li @ (a @ (li_t @ x))

    def cholqr2(x):
        for _ in range(2):
            gram = x.transpose(-1, -2) @ x
            trace = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
            gram = gram + (jitter_rel * trace / k + 1e-30)[:, None, None] * eye
            linv = neumann_tri_inverse(clamped_cholesky(gram))
            x = x @ linv.transpose(-1, -2)
        return x

    q = q0
    for _ in range(iters):
        q = cholqr2(apply_white(q))
    small = q.transpose(-1, -2) @ apply_white(q)
    return q, 0.5 * (small + small.transpose(-1, -2))


def subspace_iterate(
    a: torch.Tensor, li: torch.Tensor, q0: torch.Tensor, iters: int, jitter_rel: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """Iterated B-whitened subspace and its small Rayleigh-Ritz matrix.

    Args:
        a: (bz, n, n) float32 bright covariances.
        li: (bz, n, n) float32 inverse Cholesky factors of the loaded dark
            covariances (lower triangular; the kernel does not read the
            entries above the diagonal, the plain version multiplies them).
        q0: (bz, n, k) float32 warm-start subspace, k a multiple of 8
            (at most 112 on the card).
        iters: whitened power steps, each followed by CholeskyQR2.

    Returns:
        ``(q, small)``: the orthonormal (bz, n, k) subspace and its
        symmetric (bz, k, k) projection q^T (Li A Li^T) q.
    """
    if _batch.via_op(a, li, q0):
        return subspace_iterate_op(a, li, q0, iters, jitter_rel)
    for name, t in (("a", a), ("li", li), ("q0", q0)):
        _build.check_input(t, name, 3, a.device)
    bz, n, k = q0.shape
    if tuple(a.shape) != (bz, n, n) or tuple(li.shape) != (bz, n, n):
        raise ValueError(
            f"a and li must be {(bz, n, n)}, got {tuple(a.shape)} and {tuple(li.shape)}"
        )
    if k % 8:
        raise ValueError("subspace width must be a multiple of 8")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if a.device.type == "cpu":
        return subspace_iterate_plain(a, li, q0, iters, jitter_rel)
    if k > MAX_WIDTH:
        raise ValueError(f"subspace width {k} > {MAX_WIDTH}: the kernel's shared memory")
    q = torch.empty_like(q0)
    small = torch.empty((bz, k, k), dtype=torch.float32, device=a.device)
    if bz and k:
        ws = torch.empty(workspace_floats(bz, n, k), dtype=torch.float32, device=a.device)
        _build.launch(
            "subspace", "subspace_iterate_launch",
            a, li, q0, q, small, ws, ws.numel(), bz, n, k, iters, float(jitter_rel),
        )
        subspace_iterate.launches += 1
    return q, small


subspace_iterate.launches = 0
subspace_iterate_op = _batch.fold(
    "subspace_iterate", subspace_iterate,
    fake=lambda a, li, q0, iters, jitter_rel=1e-6: (
        q0.new_empty(q0.shape), q0.new_empty((q0.shape[0], q0.shape[2], q0.shape[2]))),
)
