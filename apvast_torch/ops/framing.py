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


def framed_statistics(
    buf: torch.Tensor, d: torch.Tensor, j: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense statistics of already-deleted buffers.

    ``buf`` (4, M, S, N), ``d`` (2, M, K): returns ``R`` (4, S*J, S*J) with
    source-major rows of reversed taps, and ``r`` (2, S*J) of the bright
    paths (A->A, B->B) against their zone's target.
    """
    p4, m, s, _ = buf.shape
    frames = frame_buffer(buf, j)  # (4, m, s, k, j)
    k = frames.shape[-2]
    y = frames.flip(-1).permute(0, 1, 2, 4, 3).reshape(p4, m, s * j, k)
    r_mats = torch.einsum("pmak,pmbk->pab", y, y)
    r_vecs = torch.einsum("zmak,zmk->za", y[[0, 3]], d)
    return r_mats, r_vecs
