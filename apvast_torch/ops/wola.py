"""Weighted overlap-add (WOLA) filterbank primitives (port of
``apvast_tpu/ops/wola.py``). Batched over any leading axes; the time axis
is always last. :func:`windowed_block` is the hop's fused analysis
window."""

from __future__ import annotations

import math

import torch

from apvast_torch.ops.kernels import _batch


def rfft_batched(blocks: torch.Tensor, n: int) -> torch.Tensor:
    """One-sided FFT of length ``n`` along the last axis."""
    return torch.fft.rfft(blocks, n=n, dim=-1)


def irfft_batched(spectra: torch.Tensor, n: int) -> torch.Tensor:
    """One-sided inverse FFT of length ``n`` along the last axis."""
    return torch.fft.irfft(spectra, n=n, dim=-1)


def sine_window(
    block_size: int, dtype=torch.float64, device=None
) -> torch.Tensor:
    """The WOLA window ``sin(pi * n / N)``, computed in ``dtype``."""
    n = torch.arange(block_size, dtype=dtype, device=device)
    return torch.sin(math.pi / block_size * n)


def wola_analyze(window: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Window + one-sided FFT. ``blocks``: (..., block_size)."""
    return rfft_batched(window * blocks, blocks.shape[-1])


def wola_synthesize(
    window: torch.Tensor, spectra: torch.Tensor, block_size: int
) -> torch.Tensor:
    """One-sided inverse FFT + synthesis window."""
    return window * irfft_batched(spectra, block_size)


def windowed_block(window: torch.Tensor, tail: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
    """``window * cat([tail, fresh], -1)``, each half multiplied straight
    into its place in one contiguous block (``tail`` (..., block - n),
    ``fresh`` (..., n)): the block is written once, where a concatenation
    and then a window multiply write it twice. ``out=`` has no vmap rule,
    so inside ``torch.func.vmap`` this calls its op, whose rule folds the
    scene axis into the rows (``ops/kernels/_batch.py``)."""
    if _batch.via_op(tail, fresh):
        return windowed_block_op(window, tail, fresh)
    split = tail.shape[-1]
    block = tail.new_empty((*tail.shape[:-1], window.shape[-1]))
    torch.mul(tail, window[:split], out=block[..., :split])
    torch.mul(fresh, window[split:], out=block[..., split:])
    return block


windowed_block_op = _batch.fold(
    "windowed_block", windowed_block, shared=("window",),
    fake=lambda window, tail, fresh: tail.new_empty((*tail.shape[:-1], window.shape[-1])),
)


def wola_overlap_add(overlap: torch.Tensor, new_block: torch.Tensor, hop: int):
    """The reference's full-buffer overlap-add: shift ``overlap`` by
    ``hop`` (zeros in) and add the synthesized block. Returns ``(buffer,
    emitted)``, ``emitted`` the buffer's first ``hop`` samples (the hop's
    finished output); :func:`wola_overlap_add_tail` emits the same bits."""
    shifted = torch.nn.functional.pad(overlap[..., hop:], (0, hop))
    buffer = shifted + new_block
    return buffer, buffer[..., :hop]


def wola_overlap_add_tail(tail: torch.Tensor, new_block: torch.Tensor, hop: int):
    """Overlap-add with the carry reduced to the (block - hop)-sample tail
    of the reference's full-block accumulator. Returns
    ``(new_tail, emitted)`` with ``emitted`` of ``hop`` samples."""
    bh = tail.shape[-1]
    if hop >= bh:
        emit = new_block[..., :hop] + torch.nn.functional.pad(tail, (0, hop - bh))
        return new_block[..., hop:], emit
    emit = tail[..., :hop] + new_block[..., :hop]
    shifted = torch.nn.functional.pad(tail[..., hop:], (0, hop))
    return shifted + new_block[..., hop:], emit


def slide(buffer: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
    """Append ``fresh`` to a sliding time buffer, dropping the oldest
    samples; the buffer length is always preserved."""
    n = fresh.shape[-1]
    if n >= buffer.shape[-1]:
        return fresh[..., n - buffer.shape[-1] :]
    return torch.cat([buffer[..., n:], fresh], dim=-1)


def slide_tail(tail: torch.Tensor, fresh: torch.Tensor, hop: int) -> torch.Tensor:
    """Advance a tail-form sliding block by ``hop`` fresh samples."""
    l = tail.shape[-1]
    if hop >= l:
        return fresh[..., hop - l :]
    return torch.cat([tail[..., hop:], fresh], dim=-1)
