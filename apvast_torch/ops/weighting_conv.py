"""Perceptual weighting as a truncated time-domain circular convolution
(port of ``apvast_tpu/ops/weighting_conv.py``).

The exact weighting of the responses is a WOLA round trip,
``y = win * irfft(W * rfft(win * x))``. The weighting curve is smooth, so
its impulse response ``c = irfft(W)`` decays within a few dozen taps, and
truncating it to T taps turns the round trip into a circular convolution,

    y = win * (c_T (*) (win * x)),

taken as overlap-save frames against a per-(zone, mic) transposed
Toeplitz matrix: kernel K8 on the card, an einsum otherwise. The
truncation is an approximation (a production option, held by a contrast
gate); T = block reproduces the exact path to rounding.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import rowwise_circular_conv, rowwise_circular_conv_plain


def _banded_toeplitz_t(kernels: torch.Tensor, b: int, taps: int) -> torch.Tensor:
    """Transposed banded Toeplitz ``K^T[..., o, u] = c[..., o - u + T - 1]``
    (zero outside the band), o < B, u < B + T - 1, built by a
    pad-flatten-reshape shear with no gather. ``kernels``: (..., T) centred
    impulse responses (tau = -h..h). Returns a (..., B, B + T - 1) view."""
    lead = kernels.shape[:-1]
    # G[d'] = flip(c)[d' - (B-1)] inside the band, zero elsewhere.
    zeros = kernels.new_zeros(lead + (b - 1,))
    g = torch.cat([zeros, kernels.flip(-1), zeros], dim=-1)
    l = g.shape[-1]  # 2B + T - 2
    w = l + 1
    # Row o reads the window starting at B-1-o: a row-dependent shift is a
    # flatten with row stride w-1 after dropping the first B-1 entries.
    tiled = torch.nn.functional.pad(g[..., None, :].expand(*lead, b, l), (0, 1))
    flat = tiled.reshape(*lead, b * w)
    rows = flat[..., b - 1 : b - 1 + b * (w - 1)].reshape(*lead, b, w - 1)
    return rows[..., : b + taps - 1]


def weighting_kernel(
    weighting: torch.Tensor,
    block: int,
    taps: int,
    idft_cos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Centred T-tap impulse responses of the real one-sided gains
    ``weighting`` (..., bins): the inverse DFT as a matmul against the
    plan's unwindowed ``idft_cos`` (bins, block) when given, else an irfft.
    Returns (..., T), tau = -h..h at indices 0..T-1."""
    h = taps // 2
    if idft_cos is not None:
        c_full = weighting @ idft_cos  # (..., block) == irfft(weighting)
    else:
        cdtype = torch.complex128 if weighting.dtype == torch.float64 else torch.complex64
        c_full = torch.fft.irfft(weighting.to(cdtype), n=block, dim=-1).to(weighting.dtype)
    return torch.cat([c_full[..., block - h :], c_full[..., : h + 1]], dim=-1)


def circular_weighting_conv(
    x: torch.Tensor,
    kernels: torch.Tensor,
    taps: int,
    block_b: int | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Circular convolution of each row of ``x`` (4, M, S, N), in the
    engine's path order (path = 2 * signal + zone), with its zone's kernel
    of ``kernels`` (2, M, T). Returns (4, M, S, N).

    ``impl``: "pallas" is kernel K8 (its plain version for a CPU tensor),
    "einsum" the overlap-save frames as one einsum; "auto" takes K8 for a
    float32 tensor on the card and the einsum otherwise, the JAX rule with
    the TPU read as the card."""
    p, m, s, n = x.shape
    if p != 4 or kernels.shape[0] != 2:
        raise ValueError("expected 4 paths and 2 zone kernel sets")
    if taps >= n:
        raise ValueError("taps must be < block (use the exact path)")
    if block_b is None:
        # A frame size near the tap count keeps the banded product
        # square-ish and the frame and band tensors small.
        block_b = n
        for cand in (160, 200, 128, 256, 100, 320, 400, 512, 80):
            if n % cand == 0 and cand >= (taps + 1) // 2:
                block_b = cand
                break
    if impl == "auto":
        impl = "pallas" if x.dtype == torch.float32 and x.device.type == "cuda" else "einsum"
    k_t = _banded_toeplitz_t(kernels, block_b, taps)  # (2, m, B, B + T - 1)
    if impl == "pallas":
        return rowwise_circular_conv(x.contiguous(), k_t.contiguous(), taps, block_b)
    if impl != "einsum":
        raise ValueError(f"impl must be 'auto', 'pallas' or 'einsum', got {impl!r}")
    return rowwise_circular_conv_plain(x, k_t, taps, block_b)
