"""K8: per-(zone, mic) circular convolution of the response rows.

Kernel: ``apvast_torch/csrc/rowwise_conv.cu``, replacing
``apvast_tpu/ops/pallas/rowwise_conv.py::rowwise_circular_conv_pallas``.
Bound on the H100: operations (1.45 GFLOP of fp32 FMA at the north-star
shapes, 23 MB moved). One block per (zone, mic, frame, 32-row tile), one
warp per 32-output tile of it, each lane a register tile of 8 rows x 4
outputs; the frame's full depth B + T - 1 is staged in double-buffered
chunks by ``cp.async``, with the circular halo read straight from the
response rows, so no frame tensor reaches device memory. Every output is
one thread's in-order sum: no sum crosses blocks.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _batch, _build


def rowwise_circular_conv_plain(
    x: torch.Tensor, k_t: torch.Tensor, taps: int, block_b: int
) -> torch.Tensor:
    """Overlap-save frames of the circularly padded rows, each against its
    zone's ``k_t``: ``out[p, m, s, f*B + o] = sum_u xp[p, m, s, f*B + u]
    k_t[p % 2, m, o, u]`` with ``xp = [x[N-h:], x, x[:h]]``, h = T // 2,
    each scene's paths against its own ``k_t``. Any dtype; shapes as
    :func:`rowwise_circular_conv`."""
    p4, m, s, n = x.shape
    h = taps // 2
    u = block_b + taps - 1
    scenes = k_t.shape[0] // 2
    xp = torch.cat([x[..., n - h :], x, x[..., :h]], dim=-1)
    frames = xp.unfold(-1, u, block_b)  # (4C, m, s, F, U)
    frames = frames.reshape(scenes, 2, 2, m, s, n // block_b, u)  # (scene, signal, zone, ...)
    y = torch.einsum("nczmsfu,nzmou->nczmsfo", frames, k_t.reshape(scenes, 2, m, block_b, u))
    return y.reshape(p4, m, s, n)


def rowwise_circular_conv(
    x: torch.Tensor, k_t: torch.Tensor, taps: int, block_b: int
) -> torch.Tensor:
    """Circular convolution of each response row with its zone's kernel.

    ``x`` (4, M, S, N) float32 rows in engine path order (path = 2 *
    signal + zone); ``k_t`` (2, M, B, B + T - 1) float32, the transposed
    Toeplitz matrices (``ops.weighting_conv._banded_toeplitz_t``); ``taps``
    T (odd); ``block_b`` B (divides N). Returns (4, M, S, N) float32. Same
    signature and layout as the JAX ``rowwise_circular_conv_pallas``.

    Scenes folded into one launch: ``k_t`` (2 * C, ...) holds C scenes'
    zone kernels and ``x`` (4 * C, ...) their paths, scene by scene."""
    if _batch.via_op(x, k_t):
        return rowwise_circular_conv_op(x, k_t, taps, block_b)
    _build.check_input(x, "x", 4)
    _build.check_input(k_t, "k_t", 4, x.device)
    p4, m, s, n = x.shape
    scenes = max(k_t.shape[0] // 2, 1)
    if p4 != 4 * scenes:
        raise ValueError(f"x must hold 4 paths a scene ({4 * scenes} for the {scenes} scenes "
                         f"of k_t), got shape {tuple(x.shape)}")
    if taps < 1 or taps % 2 == 0 or taps // 2 >= n:
        raise ValueError(f"taps={taps} must be odd with taps // 2 < N={n}")
    if not 0 < block_b <= n or n % block_b != 0:
        raise ValueError("block_b must divide the block size")
    u = block_b + taps - 1
    if tuple(k_t.shape) != (2 * scenes, m, block_b, u):
        raise ValueError(f"k_t shape {tuple(k_t.shape)} != {(2 * scenes, m, block_b, u)}")
    if x.device.type == "cpu":
        return rowwise_circular_conv_plain(x, k_t, taps, block_b)
    out = torch.empty_like(x)
    _build.launch("rowwise_conv", "rowwise_conv_launch", x, k_t, out, m, s, n, taps, block_b,
                  scenes)
    rowwise_circular_conv.launches += 1
    return out


rowwise_circular_conv.launches = 0
rowwise_circular_conv_op = _batch.fold(
    "rowwise_circular_conv", rowwise_circular_conv,
    fake=lambda x, k_t, taps, block_b: torch.empty_like(x),
)
