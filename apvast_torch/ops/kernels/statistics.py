"""K6: the framed covariance and cross-correlation of the dense statistics.

Kernel: ``apvast_torch/csrc/statistics.cu``, replacing
``apvast_tpu/ops/pallas/statistics.py::covariance_pallas`` and its two
large-SJ variants: three VMEM tilings of one function on the TPU, one
kernel for any SJ here (no ``sym_blocks`` or ``large_sj`` knob). Bound on
the H100: operations, 41.4 GFLOP for the symmetric Gram at the north-star
shapes: 0.621 ms as fp32 FMA on the CUDA cores, 0.251 ms as the three TF32
passes the kernel runs. One block per lower-triangle 64 x 64 tile pair of
one path runs the mic and time sums inside, on the tensor cores in 3xTF32
(``csrc/tf32x3.cuh``, about fp32 accuracy). It stages each operand tile as
the few buffer slices its window rows share (the rows of one source are a
Hankel slice), double-buffered by ``cp.async``, with each row's offset into
them computed once. It writes the tile and its mirror, so R is exactly
symmetric; the diagonal blocks add the cross vector in fp32 in the same
launch. No sum crosses blocks, so results repeat run to run.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.framing import window_rows
from apvast_torch.ops.kernels import _batch, _build


def covariance_plain(
    buffers: torch.Tensor, targets: torch.Tensor, frame_length: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``R[p] = sum_m Y_pm Y_pm^T`` and ``r_cross[p, :, z] = sum_m Y_pm
    d_zm`` with the window rows ``Y_pm[sv*J + i, t] = buf[p, m, sv,
    J-1-i + t]`` formed in memory, each path against the two targets of
    its scene. Any dtype; shapes as :func:`covariance`."""
    y = window_rows(buffers, frame_length)  # (p4, m, s*j, k)
    r_mats = torch.einsum("pmak,pmbk->pab", y, y)
    scenes = targets.shape[0] // 2
    r_cross = torch.einsum(
        "cpmak,czmk->cpaz", y.reshape(scenes, -1, *y.shape[1:]),
        targets.reshape(scenes, 2, *targets.shape[1:]),
    ).reshape(r_mats.shape[0], -1, 2)
    return r_mats, r_cross


def covariance(
    buffers: torch.Tensor, targets: torch.Tensor, frame_length: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense statistics of the (sample-deleted, where the variant asks)
    buffers ``buffers`` (P, M, S, N) against the aligned targets ``targets``
    (2, M, K), K = N - J + 1, float32. Returns ``R`` (P, S*J, S*J) with
    source-major rows of reversed taps and ``r_cross`` (P, S*J, 2) against
    both zones' targets (the engine reads [0, :, 0] and [3, :, 1]). Same
    signature and layout as the JAX ``covariance_pallas``.

    Scenes folded into one launch: ``targets`` (2 * C, M, K) holds the two
    targets of each of C scenes, and the P paths are C scenes' P / C paths
    in order, path p against the targets of scene p // (P / C)."""
    if _batch.via_op(buffers, targets):
        return covariance_op(buffers, targets, frame_length)
    _build.check_input(buffers, "buffers", 4)
    _build.check_input(targets, "targets", 3, buffers.device)
    p4, m, s, n = buffers.shape
    j = frame_length
    if not 0 < j <= n:
        raise ValueError(f"frame_length={j} outside (0, N={n}]")
    k = n - j + 1
    scenes = max(targets.shape[0] // 2, 1)
    if tuple(targets.shape) != (2 * scenes, m, k):
        raise ValueError(f"targets shape {tuple(targets.shape)} != {(2 * scenes, m, k)}")
    if p4 % scenes:
        raise ValueError(f"{p4} paths do not divide among the {scenes} scenes of targets")
    if buffers.device.type == "cpu":
        return covariance_plain(buffers, targets, j)
    r_mats = torch.empty((p4, s * j, s * j), dtype=torch.float32, device=buffers.device)
    r_cross = torch.empty((p4, s * j, 2), dtype=torch.float32, device=buffers.device)
    _build.launch(
        "statistics", "statistics_launch", buffers, targets, r_mats, r_cross, p4, m, s, n, j,
        scenes,
    )
    covariance.launches += 1
    return r_mats, r_cross


covariance.launches = 0
covariance_op = _batch.fold(
    "covariance", covariance,
    fake=lambda buffers, targets, frame_length: (
        buffers.new_empty((buffers.shape[0], buffers.shape[2] * frame_length,
                           buffers.shape[2] * frame_length)),
        buffers.new_empty((buffers.shape[0], buffers.shape[2] * frame_length, 2)),
    ),
)
