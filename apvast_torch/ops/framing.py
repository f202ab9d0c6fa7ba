"""Framed statistics (port of ``apvast_tpu/ops/framing.py``).

Python-variant frame semantics (ToeplitzVariant.PYTHON): the reference's
``scipy.linalg.toeplitz(flipud(buf[:J]), buf[J:])`` equals the contiguous
frame matrix of the buffer with the sample at index J deleted. The hop
applies that deletion (or carries the buffer deleted) before it frames,
so framing here is always contiguous.
"""

from __future__ import annotations

import torch


def frame_buffer(buffer: torch.Tensor, frame_length: int) -> torch.Tensor:
    """Contiguous frames ``(..., N - J + 1, J)``: frame k is
    ``buffer[k : k + J]``."""
    return buffer.unfold(-1, frame_length, 1)


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
    r_vecs = torch.einsum("zmak,zmk->za", y[[0, 3]], d)
    return r_mats, r_vecs
