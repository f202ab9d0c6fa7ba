"""K2: mic-summed windowed lag correlations.

Kernel: ``apvast_torch/csrc/lag_corr.cu``, replacing
``apvast_tpu/ops/pallas/lag_corr.py::lag_corr_pallas``.
Bound on the H100: operations (1.87 GFLOP of fp32 FMA at the north-star
shapes, 4.6 MB of input, 57,800 outputs). One cooperative launch: the
mic x time depth of each path is cut into as many slices as the card holds
blocks, each block computes its slice's whole output cube in register
tiles of 6 s1 rows x 10 lags, and after a grid barrier every output sums
its slices' partials in slice order: no atomics, results repeat run to
run, fp32 throughout. The partials live in a workspace whose size the
kernel's library gives per shape (:func:`workspace_floats`).
"""

from __future__ import annotations

import ctypes

import torch

from apvast_torch.ops.kernels import _batch, _build


def lag_corr_plain(x: torch.Tensor, j: int) -> torch.Tensor:
    """``C0[p, s1, s2, l] = sum_{m, t<K} x[p, m, s1, t] x[p, m, s2, t + l]``
    for l < J, K = N - J + 1; ``x`` (P, M, S, N) -> (P, S, S, J)."""
    k = x.shape[-1] - j + 1
    shifted = x.unfold(-1, k, 1)  # (P, M, S, J, K): [..., l, t] = x[..., t + l]
    return torch.einsum("pmst,pmult->psul", x[..., :k], shifted)


_workspace: dict[tuple, int] = {}


def workspace_floats(shape: tuple[int, int, int, int], j: int, device: torch.device) -> int:
    """Floats of the card kernel's workspace for x of ``shape`` and ``j``
    lags on ``device`` (the depth slices' partials), cached per shape; raises
    ValueError where the shape's staged rows do not fit one block's shared
    memory (past ~250 sources; the CPU serves any shape)."""
    key = (*shape, j, device)
    if key not in _workspace:
        fn = _build.library("lag_corr").lag_corr_workspace_floats
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_longlong
        with torch.cuda.device(device):
            floats = fn(*shape, j)
        if floats == -1:  # cudaErrorInvalidValue
            raise ValueError(
                f"lag_corr: {shape[2]} sources x {j} lags do not fit the card kernel's shared "
                "memory (the CPU serves any shape)"
            )
        if floats < 0:
            raise RuntimeError(f"lag_corr.cu:lag_corr_workspace_floats failed: cudaError {-floats}")
        _workspace[key] = floats
    return _workspace[key]


ROWS, LAGS = 6, 10  # a thread's register tile in csrc/lag_corr.cu (kRows, kLags)


def depth_slices(shape: tuple[int, int, int, int], j: int, device: torch.device) -> int:
    """The depth slices of the card kernel's plan for x of ``shape`` and
    ``j`` lags on ``device`` (as many as the card holds blocks for the P
    paths, so fewer as P grows; 1: one plain launch, no workspace)."""
    p4, _, s, _ = shape
    tile_floats = s * -(-s // ROWS) * -(-j // LAGS) * ROWS * LAGS
    return max(1, workspace_floats(shape, j, device) // (p4 * tile_floats))


def lag_corr(x: torch.Tensor, j: int) -> torch.Tensor:
    """Mic-summed source-pair correlations at J lags, (P, S, S, J); same
    signature and layout as the JAX ``lag_corr_pallas``."""
    if _batch.via_op(x):
        return lag_corr_op(x, j)
    _build.check_input(x, "x", 4)
    p4, m, s, n = x.shape
    if not 0 < j <= n:
        raise ValueError(f"lag count j={j} outside (0, N={n}]")
    if x.device.type == "cpu":
        return lag_corr_plain(x, j)
    out = torch.empty((p4, s, s, j), dtype=torch.float32, device=x.device)
    ws = torch.empty(workspace_floats(tuple(x.shape), j, x.device), dtype=torch.float32,
                     device=x.device)
    _build.launch("lag_corr", "lag_corr_launch", x, out, ws, p4, m, s, n, j)
    lag_corr.launches += 1
    return out


lag_corr.launches = 0
lag_corr_op = _batch.fold(
    "lag_corr", lag_corr,
    fake=lambda x, j: x.new_empty((x.shape[0], x.shape[2], x.shape[2], j)),
)
