"""K7: batched small complex Hermitian eigensolver through K4's sweeps.

Kernel: the ``HERM`` form of ``apvast_torch/csrc/jacobi_eigh.cu``,
replacing ``apvast_tpu/ops/pallas/jacobi_eigh.py::jacobi_eigh_hermitian``.
The FD engine calls it once per hop on its whitened per-bin pencils
((2 * bins, S * B, S * B) complex64, ``fd_jacobi_sweeps`` cold sweeps).
H = X + iY is embedded as the real symmetric T = [[X, -Y], [Y, X]], whose
eigenvalues come in pairs with eigenvectors (u; v) and (-v; u). K4's
sweeps and ranking on T, then every other ranked column as a complex
vector u + iv, a repair where two selected columns overlap by more than
0.7 (an interleaved pair: the odd neighbour replaces the duplicate), and
one Gram-Schmidt pass of each column against the previous selected one,
as the TPU wrapper does it (not sequential Gram-Schmidt). The kernel does
all of it in one launch; the embedding lives in shared memory only.

Up to ``PAIR_SLOTS`` padded slots the card runs the pair-block form: a
block of a few warps a pencil rotates A in place along the relabeled pair
table (``jacobi_eigh.pair_table``) instead of moving it every round, and
V's rows in registers, the same rotations in the same order; wider pencils
take K4's template form.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _batch, _build
from apvast_torch.ops.kernels.jacobi_eigh import (
    PAIR_SLOTS,
    jacobi_eigh_plain,
    padded_size,
    pair_table,
    schedule,
    workspace,
)


def embed(h: torch.Tensor) -> torch.Tensor:
    """The real symmetric (..., 2n, 2n) embedding [[X, -Y], [Y, X]] of
    H = X + iY, in float32."""
    x, y = h.real.float(), h.imag.float()
    return torch.cat([torch.cat([x, -y], -1), torch.cat([y, x], -1)], -2)


def select_pairs(w2: torch.Tensor, v2: torch.Tensor, n: int):
    """One complex eigenpair of every J-pair of the ranked real eigenpairs
    ``w2`` (..., 2n), ``v2`` (..., 2n, 2n) of the embedding, with the
    re-pairing repair and the single Gram-Schmidt pass of the TPU wrapper
    (``jacobi_eigh.py:326-345``)."""
    w = w2[..., 0::2]
    q = torch.complex(v2[..., :n, 0::2], v2[..., n:, 0::2])
    if n > 1:
        p = torch.complex(v2[..., :n, 1::2], v2[..., n:, 1::2])
        overlap = (q[..., :, :-1].conj() * q[..., :, 1:]).sum(-2).abs()
        dup = torch.cat([torch.zeros_like(overlap[..., :1], dtype=torch.bool),
                         overlap > 0.7], -1)
        q = torch.where(dup[..., None, :], p, q)
        w = torch.where(dup, w2[..., 1::2], w)
        prev = q[..., :, :-1]
        o = (prev.conj() * q[..., :, 1:]).sum(-2)
        corr = q[..., :, 1:] - prev * o[..., None, :]
        nrm = torch.sqrt((corr.real**2 + corr.imag**2).sum(-2, keepdim=True))
        corr = corr / torch.clamp_min(nrm, torch.finfo(nrm.dtype).tiny)
        q = torch.cat([q[..., :, :1], corr], -1)
    return w, q


def jacobi_eigh_hermitian_plain(h: torch.Tensor, sweeps: int):
    """The TPU wrapper's formula: the embedding, K4's plain version, the
    pair selection. Shapes as :func:`jacobi_eigh_hermitian`."""
    w2, v2 = jacobi_eigh_plain(embed(h), sweeps)
    return select_pairs(w2, v2, h.shape[-1])


def jacobi_eigh_hermitian(h: torch.Tensor, sweeps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of a batch of small complex Hermitian matrices.

    Args:
        h: (B, n, n) complex64 Hermitian, contiguous; on the card 2n <= 512.
        sweeps: full Jacobi sweeps of the embedding.

    Returns:
        ``(w (B, n) float32, q (B, n, n) complex64)``: eigenvalues ascending,
        unit eigenvectors in the columns of q, each up to a phase.
    """
    if _batch.via_op(h):
        return jacobi_eigh_hermitian_op(h, sweeps)
    if not isinstance(h, torch.Tensor) or h.dtype != torch.complex64:
        raise ValueError(f"h must be a complex64 tensor (a float32 kernel), got "
                         f"{getattr(h, 'dtype', type(h))}")
    _build.check_input(torch.view_as_real(h), "h", 4)
    bz, n, n2 = h.shape
    if n != n2 or n < 1:
        raise ValueError(f"h must be a batch of square matrices, got {tuple(h.shape)}")
    if sweeps < 0:
        raise ValueError("sweeps must be >= 0")
    if h.device.type == "cpu":
        return jacobi_eigh_hermitian_plain(h, sweeps)
    npad = padded_size(2 * n)
    work = workspace(bz, npad, h.device)
    pairs = pair_table(npad, h.device) if npad <= PAIR_SLOTS else None
    w = torch.empty((bz, n), dtype=torch.float32, device=h.device)
    q = torch.empty((bz, n, n), dtype=torch.complex64, device=h.device)
    if bz:
        _build.launch("jacobi_eigh", "jacobi_eigh_hermitian_launch", torch.view_as_real(h),
                      schedule(npad, h.device), pairs, w, torch.view_as_real(q), work, bz, n,
                      npad, sweeps)
        jacobi_eigh_hermitian.launches += 1
    return w, q


jacobi_eigh_hermitian.launches = 0
jacobi_eigh_hermitian_op = _batch.fold(
    "jacobi_eigh_hermitian", jacobi_eigh_hermitian,
    fake=lambda h, sweeps: (h.new_empty(h.shape[:2], dtype=torch.float32), h.new_empty(h.shape)),
)
