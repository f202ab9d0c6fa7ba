"""K1: streaming FIR bank (stage 1 of the hop).

Kernel: ``apvast_torch/csrc/streaming_conv.cu``, replacing
``apvast_tpu/ops/pallas/streaming_conv.py::streaming_conv_pallas``.
Bound on the H100: operations, 4.31 GFLOP at the north-star shapes against
~14.4 MB: 0.0643 ms as fp32 FMA on the CUDA cores, 0.0261 ms as the three
TF32 passes the kernel runs. The kernel never builds the (taps, hop) window
matrix the TPU kernel built: it runs the product on the tensor cores in
3xTF32 (``csrc/tf32x3.cuh``: each operand split into a TF32 high and low
part, three MMAs, about fp32 accuracy), reading its B fragments straight
from a staged segment slice (the window matrix is Toeplitz), with the tap
chunks double-buffered by ``cp.async`` (design notes in the source). Its
sums differ from the plain version's by rounding: within 1e-4 of scale, and
within twice the plain version's own error against float64.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _build


def streaming_conv_plain(
    segments: torch.Tensor, kernels: torch.Tensor, hop: int
) -> torch.Tensor:
    """``out[z, r, h] = sum_k kernels[z, r, k] * segments[z, hist + h - k]``
    with ``hist = seg_len - hop``: the window matrix
    ``W[z, k, h] = segments[z, hist - k + h]`` times the kernel rows."""
    taps = kernels.shape[-1]
    hist = segments.shape[-1] - hop
    windows = segments.unfold(-1, hop, 1)[:, hist - taps + 1 : hist + 1].flip(1)
    return kernels @ windows


def streaming_conv(
    segments: torch.Tensor, kernels: torch.Tensor, hop: int
) -> torch.Tensor:
    """Valid streaming-convolution outputs ``(signals, rows, hop)`` of the
    FIR rows ``kernels`` (signals, rows, taps) over ``segments``
    (signals, seg_len) = carried history ++ new hop samples. Same
    signature and layout as the JAX ``streaming_conv_pallas``."""
    _build.check_input(segments, "segments", 2)
    _build.check_input(kernels, "kernels", 3, segments.device)
    z, seg_len = segments.shape
    zk, rows, taps = kernels.shape
    if zk != z:
        raise ValueError(f"kernels have {zk} signals, segments {z}")
    if not 0 < hop <= seg_len:
        raise ValueError(f"hop={hop} outside (0, seg_len={seg_len}]")
    if seg_len - hop < taps - 1:
        raise ValueError("segment history shorter than taps - 1")
    if segments.device.type == "cpu":
        return streaming_conv_plain(segments, kernels, hop)
    out = torch.empty((z, rows, hop), dtype=torch.float32, device=segments.device)
    _build.launch(
        "streaming_conv", "streaming_conv_launch",
        segments, kernels, out, z, seg_len, rows, taps, hop,
    )
    streaming_conv.launches += 1
    return out


streaming_conv.launches = 0
