"""K3: lag tables -> source-major covariance rows, full or half form.

Kernel: ``apvast_torch/csrc/skew_assembly.cu``, replacing
``apvast_tpu/ops/pallas/skew_assembly.py::lag_skew_assemble`` in both
forms: ``half_scaled=True`` writes the half matrix M with R = M + M^T
(strict-upper-tap lanes zero, tap-diagonal lanes halved at write time),
which the tracking solver consumes without a symmetric completion.
Bound on the H100: bytes (the 10.24 MB output of the north-star shapes).
The TPU kernel's sequential band recursion
``acc_a = shift_left(acc_{a-1}) + lhsT[a] . rhs`` unrolls into running
sums along lane diagonals that never leave a (p, s1, s2) J x J tile: a
block computes the tile's products for a group of source blocks in
register tiles, in row bands (:func:`skew_plan`), and sums the diagonals
in place in shared memory. Unlike the TPU kernel it serves any source
count (no multiple-of-8 rule, no lane padding) and writes zeros, not
garbage, in the strict-upper-tap lanes.
"""

from __future__ import annotations

import math

import torch

from apvast_torch.ops.kernels import _batch, _build

SMEM_LIMIT = 227 * 1024  # bytes of shared memory a block may use
SMEM_PREFERRED = 96 * 1024  # the whole J x J tile up to this: two blocks an SM


def skew_plan(j: int, c: int) -> tuple[int, int]:
    """The kernel's plan ``(g, band)``: ``g`` source blocks a block, the
    fewest with g * J a multiple of 4 (rows store as float4), and T walked
    in bands of ``band`` rows (a multiple of 4): the whole tile (J rounded
    up to 4) if its shared memory, ``skew_smem_bytes``, stays within
    SMEM_PREFERRED, else the widest band within it, else the widest within
    SMEM_LIMIT. Raises ValueError when not even 4 rows fit."""
    g = 4 // math.gcd(j, 4)
    top = -(-j // 4) * 4
    for limit in (SMEM_PREFERRED, SMEM_LIMIT):
        band = next((b for b in range(top, 0, -4) if skew_smem_bytes(j, c, g, b) <= limit), 0)
        if band:
            return g, band
    raise ValueError(
        f"K3 on the card: C={c} rows of {g * j} staged lanes (J={j}) and a 4-row band "
        f"need {skew_smem_bytes(j, c, g, 4)} bytes of shared memory, above the block's "
        f"{SMEM_LIMIT} (227 KB)")


def skew_smem_bytes(j: int, c: int, g: int, band: int) -> int:
    """Shared memory of a block (``smem_bytes`` in the source): the staged rhs columns (C x gJ), a band of T (band x gJ), the
    band's lhs rows (C x band) and the diagonals' sums (gJ) in float32, and
    the list of the band's 4 x 4 tiles with its count in int32."""
    ld = g * j
    return 4 * (c * ld + band * ld + c * band + ld + (band // 4) * (ld // 4) + 1)


def lag_skew_assemble_plain(
    lhs_t: torch.Tensor,
    rhs_sm: torch.Tensor,
    c0_sm: torch.Tensor,
    j: int,
    half_scaled: bool = False,
) -> torch.Tensor:
    """The band recursion ``acc_0 = c0 + T_0``,
    ``acc_a = shift_left(acc_{a-1}) + T_a`` with ``T_a = lhsT[a] @ rhs``,
    row band t1 = J-1-a = acc_a; strict-upper-tap lanes (t2 > t1) zeroed,
    and with ``half_scaled`` the tap-diagonal lanes (t2 == t1) halved.
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
    out = out.masked_fill(upper, 0.0)
    if half_scaled:
        out = torch.where(t2[None, :] == t1[:, None], 0.5 * out, out)
    return out


def lag_skew_assemble(
    lhs_t: torch.Tensor,
    rhs_sm: torch.Tensor,
    c0_sm: torch.Tensor,
    j: int,
    half_scaled: bool = False,
) -> torch.Tensor:
    """Source-major lower-tap-triangle covariance rows.

    Args (same layout as the JAX ``lag_skew_assemble``):
        lhs_t: (P, J*S1, C) — ``lhs_t[p, a*S1 + s1, c]`` = edge factor
            x1[c][a] of source s1 (row a = 0 all zero).
        rhs_sm: (P, C, S2*J) — ``rhs_sm[p, c, s2*J + t2]`` = x2[c][J-1-t2].
        c0_sm: (P, S1, S2*J) — ``C0[p, s1, s2, J-1-t2]``.
        j: filter length J.
        half_scaled: halve the tap-diagonal lanes (the half form M).

    Returns:
        (P, S1, J, S2*J): row band ``[p, s1, t1]`` is covariance row
        (s1, t1), valid at lanes with t2 <= t1 and zero above; with
        ``half_scaled`` the lanes t2 == t1 hold half of it.
    """
    if _batch.via_op(lhs_t, rhs_sm, c0_sm):
        return lag_skew_assemble_op(lhs_t, rhs_sm, c0_sm, j, half_scaled)
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
    if lhs_t.device.type == "cpu":
        return lag_skew_assemble_plain(lhs_t, rhs_sm, c0_sm, j, half_scaled)
    g, band = skew_plan(j, c)
    out = torch.empty((p, s1, j, w), dtype=torch.float32, device=lhs_t.device)
    _build.launch(
        "skew_assembly", "skew_assembly_launch",
        lhs_t, rhs_sm, c0_sm, out, p, s1, j, c, w, int(half_scaled), g, band,
    )
    lag_skew_assemble.launches += 1
    return out


lag_skew_assemble.launches = 0
lag_skew_assemble_op = _batch.fold(
    "lag_skew_assemble", lag_skew_assemble,
    fake=lambda lhs_t, rhs_sm, c0_sm, j, half_scaled=False: lhs_t.new_empty(
        (lhs_t.shape[0], lhs_t.shape[1] // j, j, rhs_sm.shape[-1])),
)
