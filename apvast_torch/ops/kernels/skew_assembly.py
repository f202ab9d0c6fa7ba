"""K3: lag tables -> source-major covariance rows (full form).

Kernel: ``apvast_torch/csrc/skew_assembly.cu``, replacing
``apvast_tpu/ops/pallas/skew_assembly.py::lag_skew_assemble`` with
``half_scaled=False`` (the half form comes with the tracking solver).
Bound on the H100: bytes (the 10.24 MB output of the north-star shapes).
The TPU kernel's sequential band recursion
``acc_a = shift_left(acc_{a-1}) + lhsT[a] . rhs`` unrolls into independent
running sums along lane diagonals, so one thread per (path, s1, diagonal)
carries its sum in a register. Unlike the TPU kernel it serves any source
count (no multiple-of-8 rule, no lane padding) and writes zeros, not
garbage, in the strict-upper-tap lanes.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _build


def lag_skew_assemble_plain(
    lhs_t: torch.Tensor, rhs_sm: torch.Tensor, c0_sm: torch.Tensor, j: int
) -> torch.Tensor:
    """The band recursion ``acc_0 = c0 + T_0``,
    ``acc_a = shift_left(acc_{a-1}) + T_a`` with ``T_a = lhsT[a] @ rhs``,
    row band t1 = J-1-a = acc_a; strict-upper-tap lanes (t2 > t1) zeroed.
    Shapes as :func:`lag_skew_assemble`."""
    p, js1, c = lhs_t.shape
    s1 = js1 // j
    w = rhs_sm.shape[-1]
    terms = lhs_t.reshape(p, j, s1, c) @ rhs_sm[:, None]  # (p, j, s1, w)
    out = torch.empty((p, s1, j, w), dtype=lhs_t.dtype, device=lhs_t.device)
    acc = c0_sm
    for a in range(j):
        if a:
            acc = torch.roll(acc, -1, dims=-1)
        acc = acc + terms[:, a]
        out[:, :, j - 1 - a] = acc
    t2 = torch.arange(w, device=lhs_t.device) % j
    t1 = torch.arange(j, device=lhs_t.device)
    upper = t2[None, :] > t1[:, None]  # (j, w)
    return out.masked_fill(upper, 0.0)


def lag_skew_assemble(
    lhs_t: torch.Tensor, rhs_sm: torch.Tensor, c0_sm: torch.Tensor, j: int
) -> torch.Tensor:
    """Source-major lower-tap-triangle covariance rows.

    Args (same layout as the JAX ``lag_skew_assemble``):
        lhs_t: (P, J*S1, C) — ``lhs_t[p, a*S1 + s1, c]`` = edge factor
            x1[c][a] of source s1 (row a = 0 all zero).
        rhs_sm: (P, C, S2*J) — ``rhs_sm[p, c, s2*J + t2]`` = x2[c][J-1-t2].
        c0_sm: (P, S1, S2*J) — ``C0[p, s1, s2, J-1-t2]``.
        j: filter length J.

    Returns:
        (P, S1, J, S2*J): row band ``[p, s1, t1]`` is covariance row
        (s1, t1), valid at lanes with t2 <= t1 and zero above.
    """
    _build.check_input(lhs_t, "lhs_t", 3)
    _build.check_input(rhs_sm, "rhs_sm", 3, lhs_t.device)
    _build.check_input(c0_sm, "c0_sm", 3, lhs_t.device)
    p, js1, c = lhs_t.shape
    if j <= 0 or js1 % j:
        raise ValueError(f"lhs_t rows {js1} are not a multiple of J={j}")
    s1 = js1 // j
    w = rhs_sm.shape[-1]
    if rhs_sm.shape[:2] != (p, c) or w % j:
        raise ValueError(f"rhs_sm shape {tuple(rhs_sm.shape)} does not match lhs_t")
    if tuple(c0_sm.shape) != (p, s1, w):
        raise ValueError(f"c0_sm shape {tuple(c0_sm.shape)} != {(p, s1, w)}")
    if j * c * 4 > 227 * 1024:
        raise ValueError("J * C lhs rows exceed the block's shared memory")
    if lhs_t.device.type == "cpu":
        return lag_skew_assemble_plain(lhs_t, rhs_sm, c0_sm, j)
    out = torch.empty((p, s1, j, w), dtype=torch.float32, device=lhs_t.device)
    _build.launch(
        "skew_assembly", "skew_assembly_launch",
        lhs_t, rhs_sm, c0_sm, out, p, s1, j, c, w,
    )
    lag_skew_assemble.launches += 1
    return out


lag_skew_assemble.launches = 0
