"""K2: mic-summed windowed lag correlations.

Kernel: ``apvast_torch/csrc/lag_corr.cu``, replacing
``apvast_tpu/ops/pallas/lag_corr.py::lag_corr_pallas``.
Bound on the H100: operations (1.87 GFLOP of fp32 FMA at the north-star
shapes, 4.6 MB of input). Blocks run in no order, so each block owns a
whole (path, s2, s1 tile, lag tile) output tile and runs the mic sum and
the time loop inside: no atomics, results repeat run to run, fp32
throughout.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _build


def lag_corr_plain(x: torch.Tensor, j: int) -> torch.Tensor:
    """``C0[p, s1, s2, l] = sum_{m, t<K} x[p, m, s1, t] x[p, m, s2, t + l]``
    for l < J, K = N - J + 1; ``x`` (P, M, S, N) -> (P, S, S, J)."""
    k = x.shape[-1] - j + 1
    shifted = x.unfold(-1, k, 1)  # (P, M, S, J, K): [..., l, t] = x[..., t + l]
    return torch.einsum("pmst,pmult->psul", x[..., :k], shifted)


def lag_corr(x: torch.Tensor, j: int) -> torch.Tensor:
    """Mic-summed source-pair correlations at J lags, (P, S, S, J); same
    signature and layout as the JAX ``lag_corr_pallas``."""
    _build.check_input(x, "x", 4)
    p4, m, s, n = x.shape
    if not 0 < j <= n:
        raise ValueError(f"lag count j={j} outside (0, N={n}]")
    if x.device.type == "cpu":
        return lag_corr_plain(x, j)
    out = torch.empty((p4, s, s, j), dtype=torch.float32, device=x.device)
    _build.launch("lag_corr", "lag_corr_launch", x, out, p4, m, s, n, j)
    lag_corr.launches += 1
    return out


lag_corr.launches = 0
