"""Framed statistics (port of ``apvast_tpu/ops/framing.py``).

Python-variant frame semantics (ToeplitzVariant.PYTHON): the reference's
``scipy.linalg.toeplitz(flipud(buf[:J]), buf[J:])`` equals the contiguous
frame matrix of the buffer with the sample at index J deleted. The hop
applies that deletion (or carries the buffer deleted) before it frames,
so the engine frames contiguously (the MATLAB variant, the default here).
"""

from __future__ import annotations

import torch

from apvast_torch.config import ToeplitzVariant


def frame_buffer(
    buffer: torch.Tensor,
    frame_length: int,
    variant: ToeplitzVariant = ToeplitzVariant.MATLAB,
) -> torch.Tensor:
    """Sliding frames ``(..., K, J)``: frame k is ``buffer[k : k + J]`` of
    the buffer, contiguous (MATLAB, K = N - J + 1) or with the sample at
    index J deleted first (PYTHON, K = N - J)."""
    j = frame_length
    if variant is ToeplitzVariant.PYTHON:
        buffer = torch.cat([buffer[..., :j], buffer[..., j + 1 :]], dim=-1)
    return buffer.unfold(-1, j, 1)


def statistics_matrices(frames: torch.Tensor, target: torch.Tensor | None, frame_length: int):
    """One path's spatial correlation matrix R and cross vector r.

    ``frames`` (M, S, K, J) of the weighted loudspeaker responses,
    ``target`` (M, N) weighted target buffer of the zone or None. Returns
    ``(R (S*J, S*J), r (S*J,) or None)`` in the reference's block layout:
    row block s holds source s's taps, row i of a block lag i (the
    flipped Toeplitz columns); the microphone sum is in the contraction,
    and r pairs the frames with the target's last K samples."""
    m, s, k, j = frames.shape
    y = frames.flip(-1).permute(0, 1, 3, 2).reshape(m, s * j, k)
    r_mat = torch.einsum("mak,mbk->ab", y, y)
    r_vec = None if target is None else torch.einsum("mak,mk->a", y, target[..., -k:])
    return r_mat, r_vec


def window_rows(buf: torch.Tensor, j: int) -> torch.Tensor:
    """The statistics' window rows ``(P, M, S*J, K)`` of buffers ``buf``
    (P, M, S, N): row ``sv*J + i`` is ``buf[..., sv, J-1-i : J-1-i+K]``
    (source-major, reversed taps), K = N - J + 1."""
    p, m, s, _ = buf.shape
    frames = frame_buffer(buf, j)  # (p, m, s, k, j)
    return frames.flip(-1).permute(0, 1, 2, 4, 3).reshape(p, m, s * j, frames.shape[-2])


def framed_statistics(
    buf: torch.Tensor, d: torch.Tensor, j: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense statistics of already-deleted buffers.

    ``buf`` (4, M, S, N), ``d`` (2, M, K): returns ``R`` (4, S*J, S*J) with
    source-major rows of reversed taps, and ``r`` (2, S*J) of the bright
    paths (A->A, B->B) against their zone's target.
    """
    y = window_rows(buf, j)
    r_mats = torch.einsum("pmak,pmbk->pab", y, y)
    r_vecs = torch.einsum("zmak,zmk->za", y[0::3].contiguous(), d)
    return r_mats, r_vecs
