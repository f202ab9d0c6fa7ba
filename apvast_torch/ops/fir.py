"""Streaming FIR convolution by batched overlap-save FFT (port of
``apvast_tpu/ops/fir.py``): the reference's per-(src, mic) stateful
``lfilter`` loop as one batched frequency-domain product. An FIR filter's
delay line is the last ``fft_size - hop`` input samples, so one history a
program signal carries every path's state; with ``fft_size >= taps + hop
- 1`` the last ``hop`` samples of the circular convolution are the
linear one's."""

from __future__ import annotations

import torch

from apvast_torch.ops.wola import irfft_batched, rfft_batched


def fir_kernel_spectra(kernels: torch.Tensor, fft_size: int) -> torch.Tensor:
    """One-sided spectra of FIR kernels ``(..., taps)`` at ``fft_size``."""
    return rfft_batched(kernels, fft_size)


def streaming_fir(history: torch.Tensor, hop_samples: torch.Tensor, kernel_spectra: torch.Tensor):
    """Advance the convolution by one hop.

    ``history`` (fft_size - hop,) carried input samples (zeros at the
    start, as the reference's zero filter states), ``hop_samples`` (hop,),
    ``kernel_spectra`` (..., fft_size // 2 + 1) from
    :func:`fir_kernel_spectra`, any leading batch axes. Returns
    ``(new_history, outputs)``, outputs (..., hop): every kernel's output
    samples aligned with ``hop_samples``."""
    hop = hop_samples.shape[-1]
    segment = torch.cat([history, hop_samples])
    fft_size = segment.shape[-1]
    full = irfft_batched(kernel_spectra * torch.fft.rfft(segment), fft_size)
    return segment[hop:], full[..., fft_size - hop :]
