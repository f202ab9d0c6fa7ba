"""Lag-domain statistics: the Toeplitz Gram from lag correlations (port of
``apvast_tpu/ops/lag_statistics.py``).

The spatial-correlation matrices ``R = sum_m Y_m Y_m^T`` have rows that are
shifted copies of the same per-source signals, so every entry is a
windowed lag correlation,

    R[(s1,t1),(s2,t2)] = C_{a,b} = sum_{t<K} x1[t+a] x2[t+b],
    a = J-1-t1, b = J-1-t2,

and along each diagonal C obeys the rank-1 recurrence
``C_{a,b} = C_{a-1,b-1} + x1[a+K-1] x2[b+K-1] - x1[a-1] x2[b-1]``. So R is
the full-window correlations C0 at J lags plus cumulative edge
corrections. The arithmetic is the dense Gram's, in another summation
order. Four assemblies lay R out:

- "skew" (production): C0 by kernel K2, the layout by kernel K3,
  source-major, optionally the half form M with R = M + M^T;
- "pair": diagonal tables per source pair, sheared into (J, J) blocks;
- "tap": tap-major R'[(t1,s1),(t2,s2)] = R[(s1,t1),(s2,t2)] by two wide
  row shears and a cumulative-sum matmul (the solver sees a symmetrically
  permuted pencil; the engine extracts filters tap-major);
- "wide": the tap-major assembly relabelled source-major.

C0 comes from ``c0_method``: "pallas" (kernel K2, ``ops/kernels/lag_corr``),
"conv" (a grouped ``conv1d``), "matmul" (shift stacks, one microphone at a
time) or "fft" (half-spectrum DFT matmuls); "auto" takes K2 for float32 on
the card and "conv" otherwise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from apvast_torch.ops.kernels import lag_corr, lag_skew_assemble


def _c0_conv(x: torch.Tensor, k: int) -> torch.Tensor:
    """``C0[p, s1, s2, l] = sum_{m, t<k} x[p, m, s1, t] x[p, m, s2, t + l]``
    for l <= N - K, ``x`` (P, M, S, N), by one grouped cross-correlation:
    batch s2, the paths as groups, the microphones as channels."""
    p4, m, s, n = x.shape
    lhs = x.permute(2, 0, 1, 3).reshape(s, p4 * m, n)  # (s2, (p, m), N)
    weight = x[..., :k].permute(0, 2, 1, 3).reshape(p4 * s, m, k)  # ((p, s1), m, K)
    out = F.conv1d(lhs, weight, groups=p4)  # (s2, (p, s1), L)
    return out.reshape(s, p4, s, -1).permute(1, 2, 0, 3)


def _c0_matmul(x: torch.Tensor, k: int) -> torch.Tensor:
    """The correlations of :func:`_c0_conv` as a matmul against shift
    stacks, one microphone at a time (all at once would hold N S J values
    a path and microphone)."""
    p4, m, s, n = x.shape
    acc = x.new_zeros((p4, s, s, n - k + 1))
    for xm in x.unbind(1):  # (P, S, N)
        acc = acc + torch.einsum("pst,pult->psul", xm[..., :k], xm.unfold(-1, k, 1))
    return acc


def _c0_fft(x: torch.Tensor, j: int) -> torch.Tensor:
    """The correlations through the half-spectrum DFT identity
    ``sum_{t<K} x1[t] x2[t+l] = (1/N) sum_f a_f Re(conj(U_f) V_f e^{2 pi i f l / N})``
    (U the DFT of the K-truncated signal, V of the whole buffer, a_f the
    one-sided fold weights), every stage a matmul against DFT constants.
    Lags below J never wrap (t + l <= N - 1), so the circular correlation
    is the linear one; U is V less the DFT of the (J-1)-sample tail."""
    p4, m, s, n = x.shape
    k = n - j + 1
    f = n // 2 + 1
    ang = (2.0 * np.pi / n) * (np.arange(n)[:, None] * np.arange(f)[None, :])
    const = lambda a: torch.as_tensor(a, dtype=x.dtype, device=x.device)  # noqa: E731
    cos_m, sin_m = const(np.cos(ang)), const(np.sin(ang))  # (N, F)
    alpha = np.full(f, 2.0)
    alpha[0] = 1.0
    if n % 2 == 0:
        alpha[-1] = 1.0
    angl = (2.0 * np.pi / n) * (np.arange(j)[None, :] * np.arange(f)[:, None])
    wc = const(np.cos(angl) * alpha[:, None] / n)  # (F, J)
    ws = const(np.sin(angl) * alpha[:, None] / n)

    v_re = x @ cos_m
    v_im = -(x @ sin_m)
    tail = x[..., k:]  # positions k..N-1
    u_re = v_re - tail @ cos_m[k:]
    u_im = v_im + tail @ sin_m[k:]
    # conj(U[s1]) V[s2] summed over microphones, per bin.
    g_re = (torch.einsum("pmaf,pmbf->pabf", u_re, v_re)
            + torch.einsum("pmaf,pmbf->pabf", u_im, v_im))
    g_im = (torch.einsum("pmaf,pmbf->pabf", u_re, v_im)
            - torch.einsum("pmaf,pmbf->pabf", u_im, v_re))
    return g_re @ wc - g_im @ ws


def _compute_c0(buf: torch.Tensor, j: int, c0_method: str) -> torch.Tensor:
    """The full-window correlations (P, S, S, J) of ``buf`` (P, M, S, N)
    by ``c0_method`` (module docstring)."""
    k = buf.shape[-1] - j + 1
    if c0_method == "auto":
        c0_method = (
            "pallas" if buf.dtype == torch.float32 and buf.device.type == "cuda" else "conv"
        )
    if c0_method == "pallas":
        return lag_corr(buf.contiguous(), j)
    if c0_method == "conv":
        return _c0_conv(buf, k)
    if c0_method == "matmul":
        return _c0_matmul(buf, k)
    if c0_method == "fft":
        return _c0_fft(buf, j)
    # A typo must not fall through to another method's times.
    raise ValueError(f"unknown c0_method: {c0_method!r}")


def _check_target(buf: torch.Tensor, d: torch.Tensor, j: int) -> None:
    k = buf.shape[-1] - j + 1
    if d.shape[-1] != k:
        raise ValueError(f"target buffer must have K={k} samples")


def _shear_tables(t_tab: torch.Tensor) -> torch.Tensor:
    """Diagonal tables laid out as the lower (t1 >= t2) part of (J, J)
    blocks, ``M[..., t1, t2] = T[..., J-1-t1, t1-t2]`` (garbage above the
    diagonal, masked by the caller): a row-dependent shift as a flatten and
    a reshape with a row stride one short of the padded width."""
    j = t_tab.shape[-1]
    b1 = t_tab.flip(-2).flip(-1)  # B1[..., t1, i] = T[..., J-1-t1, J-1-i]
    flat = F.pad(b1, (0, j)).reshape(*b1.shape[:-2], 2 * j * j)
    g = flat[..., j - 1 : j - 1 + j * (2 * j - 1)]
    return g.reshape(*g.shape[:-1], j, 2 * j - 1)[..., :j]


def _edge_tables(x1e: torch.Tensor, x2e: torch.Tensor, j: int) -> torch.Tensor:
    """``D[p, s1, s2, i, l] = sum_m x1e[p, m, s1, i] x2e[p, m, s2, i + l]``
    for i < E1, l < J: the microphone-summed outer product of the edge
    snippets, sheared to diagonals by a reshape with row stride E2 + 1."""
    e1, e2 = x1e.shape[-1], x2e.shape[-1]
    o = torch.einsum("pmsi,pmtv->pstiv", x1e, x2e)  # (4, s1, s2, i, v)
    flat = F.pad(o.reshape(*o.shape[:-2], e1 * e2), (0, e1))
    return flat.reshape(*flat.shape[:-1], e1, e2 + 1)[..., :j]


def lag_tables(buf: torch.Tensor, c0: torch.Tensor, j: int) -> torch.Tensor:
    """Diagonal tables ``T[p, s1, s2, a, l] = C_{a, a+l}``: the full-window
    correlations ``c0`` (P, S, S, J) plus the two edges' prefix sums, each
    a diagonal cumulative sum of the edge snippets' outer product."""
    k = buf.shape[-1] - j + 1
    # Right edge: PP[a, l] = sum_{i=1..a} x1[k-1+i] x2[k-1+i+l].
    kc = torch.cumsum(_edge_tables(buf[..., k - 1 : k - 1 + j], buf[..., k - 1 :], j), dim=3)
    pp = kc - kc[..., :1, :]
    # Left edge: PM[a, l] = sum_{u<a} x1[u] x2[u+l], PM[0] = 0.
    if j > 1:
        k_l = _edge_tables(buf[..., : j - 1], buf[..., : 2 * j - 2], j)
        pm = torch.cat([torch.zeros_like(k_l[..., :1, :]), torch.cumsum(k_l, dim=3)], dim=3)
    else:
        pm = torch.zeros_like(pp)
    return c0[..., None, :] + pp - pm


def assemble_lag_matrices(t_tab: torch.Tensor, j: int) -> torch.Tensor:
    """Diagonal tables (P, S, S, J, J) -> (P, S*J, S*J) source-major
    matrices: each block's lower triangle from its own table, its upper
    from the transposed pair's (C^{(s1,s2)}_{a,b} = C^{(s2,s1)}_{b,a})."""
    p4, s = t_tab.shape[0], t_tab.shape[1]
    up = _shear_tables(t_tab)
    low = _shear_tables(t_tab.transpose(1, 2)).transpose(-1, -2)
    tril = torch.ones(j, j, dtype=torch.bool, device=t_tab.device).tril()
    block = torch.where(tril, up, low)
    return block.permute(0, 1, 3, 2, 4).reshape(p4, s * j, s * j)


def _cross_corr(buf: torch.Tensor, d: torch.Tensor, j: int) -> torch.Tensor:
    """The bright paths' raw lag correlations ``r_corr[z, s, a] = sum_{m,t}
    x[pz, m, s, t + a] d[z, m, t]`` (2, S, J): the zero-padded target
    rolled to each lag (wrapped samples land in the padding)."""
    dp = F.pad(d, (0, j - 1))  # (2, m, n)
    d_shift = torch.stack([torch.roll(dp, a, dims=-1) for a in range(j)], dim=2)
    return torch.einsum("zmsu,zmau->zsa", buf[0::3], d_shift)


def cross_lag_vectors(buf: torch.Tensor, d: torch.Tensor, j: int) -> torch.Tensor:
    """``r[z, s*J + tap] = sum_{m,t} x[pz, m, s, t + J-1-tap] d[z, m, t]``
    (2, S*J), source-major."""
    return _cross_corr(buf, d, j).flip(-1).reshape(2, buf.shape[2] * j)


def covariance_via_lags(
    buf: torch.Tensor, d: torch.Tensor, j: int, c0_method: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-major statistics through the per-pair ("pair") assembly.

    Args:
        buf: (4, M, S, N) weighted-response statistics buffers, the
            PYTHON-variant sample deletion already applied.
        d: (2, M, K) weighted target buffers aligned to the K frames.
        j: filter length J.
        c0_method: the full-window correlations' method (module docstring).

    Returns:
        (r_mats (4, S*J, S*J), r_vecs (2, S*J)), the dense Gram's sums in
        another order.
    """
    _check_target(buf, d, j)
    c0 = _compute_c0(buf, j, c0_method)
    r_mats = assemble_lag_matrices(lag_tables(buf, c0, j), j)
    return r_mats, cross_lag_vectors(buf, d, j)


def _shear_rows_dec(x: torch.Tensor, sigma: int, w_out: int) -> torch.Tensor:
    """``out[..., r, q] = x[..., r, q + (R-1-r) sigma]``: pad each row by
    sigma, flatten, drop the first (R-1) sigma, read back at the original
    row stride (positions past a row's end read the next row: callers use
    only q + (R-1-r) sigma < W)."""
    *lead, r, w = x.shape
    flat = F.pad(x, (0, sigma)).reshape(*lead, r * (w + sigma))
    start = (r - 1) * sigma
    return flat[..., start : start + r * w].reshape(*lead, r, w)[..., :w_out]


def _shear_rows_neg(x: torch.Tensor, sigma: int) -> torch.Tensor:
    """``out[..., r, q] = x[..., r, q - r sigma]`` (positions before a
    row's start read the previous row's tail or padding)."""
    *lead, r, w = x.shape
    flat = F.pad(x, (0, sigma)).reshape(*lead, r * (w + sigma))
    return flat[..., : r * w].reshape(*lead, r, w)


def _tap_major_matrix(buf: torch.Tensor, j: int, c0_method: str) -> torch.Tensor:
    """The (4, S*J, S*J) tap-major covariance, ``R'[t1*S + s1, t2*S + s2] =
    C^{(s1,s2)}_{a, a+l}`` (a = J-1-t1, l = t1-t2): the edge terms of both
    edges as one product over a stacked (mic, edge) axis, sheared to
    diagonals (one wide shear), summed over i by a matmul with a
    row-reversed triangle, plus C0; the lower half by one decreasing
    shear, the upper by symmetry."""
    p4, m, s, n = buf.shape
    k = n - j + 1
    c0_t = _compute_c0(buf, j, c0_method).permute(0, 1, 3, 2)  # (4, s1, l, s2)
    # Rows i = 0..J-1 (row 0 zeroed: a = J-1 has no edge terms); columns
    # v = i + l read the same shifted position for both edges.
    zero_col = torch.zeros_like(buf[..., :1])
    x1r = torch.cat([zero_col, buf[..., k : k + j - 1]], -1)
    x1l = torch.cat([zero_col, -buf[..., : j - 1]], -1)
    x2r = buf[..., k - 1 : k - 1 + j]  # v -> buf[k-1+v]
    x2l = torch.cat([zero_col, buf[..., : j - 1]], -1)  # v -> buf[v-1]
    lhs = torch.stack([x1r, x1l], dim=2).permute(0, 1, 2, 4, 3).reshape(p4, 2 * m, j, s)
    # The column axis reversed (v' = J-1-v), so the tables' l-flip is free.
    rhs = torch.stack([x2r, x2l], dim=2).flip(-1).permute(0, 1, 2, 4, 3).reshape(p4, 2 * m, j, s)
    o = torch.einsum("pcis,pcvt->pisvt", lhs, rhs)  # (4, i, s1, v', s2)
    # E'[i, s1, l', s2] = o[i, s1, l' - i, s2]: one negative wide shear.
    e_rev = _shear_rows_neg(o.reshape(p4, j, s * j * s), s)
    # T_f[a'] = sum_{i <= J-1-a'} E'[i]: the a-flip rides in the triangle
    # (built on the device: a captured hop copies no host data).
    cum_rev = torch.ones(j, j, dtype=buf.dtype, device=buf.device).tril().flip(0)
    t_f = torch.einsum("ai,piw->paw", cum_rev, e_rev).reshape(p4, j, s, j, s)
    b_tab = c0_t.flip(2)[:, None] + t_f  # the doubly flipped tables
    low = _shear_rows_dec(b_tab.reshape(p4, j, s * j * s), s, s * j * s).reshape(p4, j * s, j * s)
    rows = torch.arange(s * j, device=buf.device) // s
    mask = rows[:, None] >= rows[None, :]
    return torch.where(mask, low, low.transpose(-1, -2))


def covariance_via_lags_tap(
    buf: torch.Tensor, d: torch.Tensor, j: int, c0_method: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tap-major statistics ("tap"): ``R'[(t1,s1),(t2,s2)] =
    R[(s1,t1),(s2,t2)]`` and r likewise, a symmetric permutation of the
    source-major pencil (the same spectrum; the eigenvectors, hence the
    filters, permute). Arguments as :func:`covariance_via_lags`."""
    _check_target(buf, d, j)
    r_mats = _tap_major_matrix(buf, j, c0_method)
    r_corr = _cross_corr(buf, d, j)  # (2, s, a)
    return r_mats, r_corr.flip(-1).permute(0, 2, 1).reshape(2, j * buf.shape[2])


def covariance_via_lags_wide(
    buf: torch.Tensor, d: torch.Tensor, j: int, c0_method: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-major statistics through the tap-major assembly ("wide", the
    JAX package's default): :func:`covariance_via_lags_tap`'s matrices
    relabelled (J, S, J, S) -> (S, J, S, J), so the solver sees the pair
    assembly's values in its order. Arguments as
    :func:`covariance_via_lags`."""
    _check_target(buf, d, j)
    p4, s = buf.shape[0], buf.shape[2]
    r_tap = _tap_major_matrix(buf, j, c0_method)
    r_mats = r_tap.reshape(p4, j, s, j, s).permute(0, 2, 1, 4, 3).reshape(p4, s * j, s * j)
    return r_mats, cross_lag_vectors(buf, d, j)


def _c0_and_cross_fused(
    buf: torch.Tensor, d: torch.Tensor, j: int, c0_method: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """C0 and the bright-path cross-correlations from one correlation pass:
    the weighted target rides as an extra source row S (zero-padded to the
    buffer length, zero on the dark paths), so row S of the (S+1)-source
    C0 is ``r_corr[z, s, a] = sum_t d_z[t] x[s, t + a]``."""
    p4, m, s, n = buf.shape
    dpad = torch.nn.functional.pad(d, (0, j - 1))  # (2, m, n)
    dark = torch.zeros_like(dpad[0])
    dz = torch.stack([dpad[0], dark, dark, dpad[1]])[:, :, None]  # (4, m, 1, n)
    ext = torch.cat([buf, dz], dim=2).contiguous()  # (4, m, s+1, n)
    c0e = _compute_c0(ext, j, c0_method)  # (4, s+1, s+1, J)
    c0 = c0e[:, :s, :s]
    r_corr = torch.stack([c0e[0, s, :s], c0e[3, s, :s]])  # (2, s, J)
    return c0, r_corr


def covariance_via_lags_skew(
    buf: torch.Tensor, d: torch.Tensor, j: int, form: str = "full", c0_method: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-major lag statistics through the skew assembly (kernel K3),
    C0 by kernel K2 on the card unless ``c0_method`` says otherwise. K2 and
    K3 are float32 kernels: on the card float64 raises; on the CPU their
    plain versions compute it, as the JAX package's interpret-mode kernels
    do.

    Args:
        buf: (4, M, S, N) weighted-response statistics buffers, the
            PYTHON-variant sample deletion already applied.
        d: (2, M, K) weighted target buffers aligned to the K frames.
        j: filter length J.
        form: "full" returns R; "half" returns M with R = M + M^T (K3's
            half form) and skips the symmetric completion pass.
        c0_method: as for :func:`covariance_via_lags` (JAX's default,
            "auto": K2 for float32 on the card, "conv" on the CPU).

    Returns:
        (r_mats (4, S*J, S*J), r_vecs (2, S*J)).
    """
    p4, m, s, n = buf.shape
    k = n - j + 1
    if d.shape[-1] != k:
        raise ValueError(f"target buffer must have K={k} samples")
    if form not in ("full", "half"):
        raise ValueError(f"form must be 'full' or 'half', got {form!r}")

    c0, r_corr = _c0_and_cross_fused(buf, d, j, c0_method)
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
        lhs_t.contiguous(), rhs_sm.contiguous(), c0_sm.contiguous(), j,
        half_scaled=(form == "half"),
    ).reshape(p4, s * j, s * j)
    r_vecs = r_corr.flip(-1).reshape(2, s * j)
    if form == "half":
        return low, r_vecs
    # Symmetric completion: valid values at t2 <= t1 within every source
    # block; R = R^T fills the strict upper-tap lanes.
    taps = torch.arange(s * j, device=buf.device) % j
    mask = taps[:, None] >= taps[None, :]
    r_mats = torch.where(mask, low, low.transpose(-1, -2))
    return r_mats, r_vecs
