"""Lag-domain statistics: the Toeplitz Gram from lag correlations (port of
the production path of ``apvast_tpu/ops/lag_statistics.py``).

The spatial-correlation matrices ``R = sum_m Y_m Y_m^T`` have rows that are
shifted copies of the same per-source signals, so every entry is a
windowed lag correlation,

    R[(s1,t1),(s2,t2)] = C_{a,b} = sum_{t<K} x1[t+a] x2[t+b],
    a = J-1-t1, b = J-1-t2,

and along each diagonal C obeys the rank-1 recurrence
``C_{a,b} = C_{a-1,b-1} + x1[a+K-1] x2[b+K-1] - x1[a-1] x2[b-1]``. So R is
the full-window correlations C0 at J lags (kernel K2) plus cumulative
edge corrections, laid out source-major by the skew assembly (kernel K3).
The arithmetic is the dense Gram's, in another summation order.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import lag_corr, lag_skew_assemble


def _c0_and_cross_fused(
    buf: torch.Tensor, d: torch.Tensor, j: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """C0 and the bright-path cross-correlations from one correlation pass:
    the weighted target rides as an extra source row S (zero-padded to the
    buffer length, zero on the dark paths), so row S of the (S+1)-source
    C0 is ``r_corr[z, s, a] = sum_t d_z[t] x[s, t + a]``."""
    p4, m, s, n = buf.shape
    dpad = torch.nn.functional.pad(d, (0, j - 1))  # (2, m, n)
    dz = torch.zeros((p4, m, 1, n), dtype=buf.dtype, device=buf.device)
    dz[0, :, 0] = dpad[0]
    dz[3, :, 0] = dpad[1]
    ext = torch.cat([buf, dz], dim=2).contiguous()  # (4, m, s+1, n)
    c0e = lag_corr(ext, j)  # (4, s+1, s+1, J); float32 only
    c0 = c0e[:, :s, :s]
    r_corr = torch.stack([c0e[0, s, :s], c0e[3, s, :s]])  # (2, s, J)
    return c0, r_corr


def covariance_via_lags_skew(
    buf: torch.Tensor, d: torch.Tensor, j: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-major lag statistics through the skew assembly, in full form
    (R itself; the half form R = M + M^T comes with the tracking solver).

    Args:
        buf: (4, M, S, N) weighted-response statistics buffers, the
            PYTHON-variant sample deletion already applied.
        d: (2, M, K) weighted target buffers aligned to the K frames.
        j: filter length J.

    Returns:
        (r_mats (4, S*J, S*J), r_vecs (2, S*J)).
    """
    p4, m, s, n = buf.shape
    k = n - j + 1
    if d.shape[-1] != k:
        raise ValueError(f"target buffer must have K={k} samples")

    c0, r_corr = _c0_and_cross_fused(buf, d, j)
    # c0 in output coordinates: c0_sm[p, s1, s2*J + t2] = c0[s1, s2, J-1-t2].
    c0_sm = c0.flip(-1).reshape(p4, s, s * j)

    # Edge factors: row i = 0 zeroed; right edge and negated left edge
    # stacked on the contraction axis c = (mic, edge).
    zero_col = torch.zeros_like(buf[..., :1])
    x1r = torch.cat([zero_col, buf[..., k : k + j - 1]], -1)
    x1l = torch.cat([zero_col, -buf[..., : j - 1]], -1)
    x2r = buf[..., k - 1 : k - 1 + j]  # v -> buf[k-1+v]
    x2l = torch.cat([zero_col, buf[..., : j - 1]], -1)  # v -> buf[v-1]
    lhs = torch.stack([x1r, x1l], dim=2).reshape(p4, 2 * m, s, j)
    rhs = torch.stack([x2r, x2l], dim=2).reshape(p4, 2 * m, s, j)
    # lhsT[p, a*S + s1, c]; rhs_sm[p, c, s2*J + t2] = x2[c][J-1-t2, s2].
    lhs_t = lhs.permute(0, 3, 2, 1).reshape(p4, j * s, 2 * m)
    rhs_sm = rhs.flip(-1).reshape(p4, 2 * m, s * j)

    low = lag_skew_assemble(
        lhs_t.contiguous(), rhs_sm.contiguous(), c0_sm.contiguous(), j
    ).reshape(p4, s * j, s * j)
    r_vecs = r_corr.flip(-1).reshape(2, s * j)
    # Symmetric completion: valid values at t2 <= t1 within every source
    # block; R = R^T fills the strict upper-tap lanes.
    taps = torch.arange(s * j, device=buf.device) % j
    mask = taps[:, None] >= taps[None, :]
    r_mats = torch.where(mask, low, low.transpose(-1, -2))
    return r_mats, r_vecs
