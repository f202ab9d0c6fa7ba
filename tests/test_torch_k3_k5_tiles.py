"""The tilings of the card's K3 (``csrc/skew_assembly.cu``) and K5/K11
(``csrc/output_filter.cu``), emulated on the CPU in their index math and
summation order, against the plain versions and the JAX Pallas functions
in interpret mode, at small shapes.

- K3: per block (p, s1, group of g source blocks, from the wrapper's
  ``skew_plan``), the staged rhs columns, each row band's lhs rows, the
  band of T as a product summed over C in order on the listed 4 x 4
  tiles (those holding a valid entry; the others NaN), the in-place
  anti-diagonal sums carried over the bands, and the row store with the
  strict-upper-tap lanes 0 and, in the half form, the tap-diagonal lanes
  halved; also with narrower bands than the plan's (the walk where J x J
  does not fit).
- K5: per block (zone, 32-row tile, 128-sample tile), the zero-padded
  filter rows, the circularly extended input slice, each thread's 8 rows
  x 4 samples summed over 4-tap steps from its 8-sample window (the last
  step guarded), and the epilogue's window, staged tail and emit/new-tail
  split; hop below, at and above block - hop; K11 as the same tiling
  without the epilogue.

The thread-tile constants are read from the CUDA source, so the
emulation follows it. Tolerance 1e-5 of scale: the emulations, the plain
versions and the interpret-mode functions sum in float32 in other orders.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_torch.ops.kernels import _build
from apvast_torch.ops.kernels.skew_assembly import skew_plan
from apvast_tpu.ops.pallas.output_filter import circular_filter_overlap_pallas, circular_filter_pallas
from apvast_tpu.ops.pallas.skew_assembly import lag_skew_assemble
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-5
F32 = np.float32


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fma(a, b, c):
    """fp32 fmaf: the product exact in float64, one rounding to float32."""
    return (np.float64(1) * a * b + c).astype(F32)


def _source_constant(name: str, constant: str) -> int:
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        return int(re.search(rf"constexpr int {constant} = (\d+);", f.read()).group(1))


# ---- K3 ---------------------------------------------------------------------


def _emulate_k3(lhs_t, rhs, c0, j, half, g, band):
    """K3's blocks one by one; unwritten outputs stay NaN."""
    p, js1, c = lhs_t.shape
    s1n, w = js1 // j, rhs.shape[-1]
    ld = g * j
    out = np.full((p, s1n, j, w), np.nan, F32)
    for pp in range(p):
        for s1 in range(s1n):
            for lane0 in range(0, w, ld):
                lanes = min(ld, w - lane0)
                rs = np.zeros((c, ld), F32)
                rs[:, :lanes] = rhs[pp, :, lane0:lane0 + lanes]
                sums = c0[pp, s1, lane0:lane0 + lanes].copy()
                d = np.arange(lanes)
                dd = d % j
                for i0 in range(0, j, band):
                    rows = min(band, j - i0)
                    ls = np.zeros((c, band), F32)  # transposed band of lhs rows
                    ls[:, :rows] = lhs_t[pp, (i0 + np.arange(rows)) * s1n + s1].T
                    ts = np.zeros((band, ld), F32)
                    for cc in range(c):  # the register tiles' order: cc = 0, 1, ...
                        ts = _fma(ls[cc][:, None], rs[cc][None, :], ts)
                    # Only the listed 4 x 4 tiles are computed; the others keep
                    # whatever shared memory held (NaN here), which no output reads.
                    i4 = i0 + 4 * (np.arange(band) // 4)
                    c4 = 4 * (np.arange(ld) // 4)
                    u = c4 % j
                    listed = (c4 < lanes)[None, :] & (
                        i4[:, None] + np.where(u + 3 >= j, 0, u)[None, :] <= j - 1)
                    ts[~listed] = np.nan
                    for i in range(i0, i0 + rows):  # every diagonal with D >= i, in step
                        on = dd >= i
                        sums[on] = (sums[on] + ts[i - i0, d[on] - i]).astype(F32)
                        ts[i - i0, d[on] - i] = sums[on]
                    for r in range(rows):
                        i = i0 + r
                        diag = i + d % j
                        v = ts[r, :lanes]
                        v = np.where(diag > j - 1, F32(0), np.where(half & (diag == j - 1),
                                                                     F32(0.5) * v, v))
                        out[pp, s1, j - 1 - i, lane0:lane0 + lanes] = v
    return out


# (S, J, C, band): the plan's band (None) and narrower ones; g = 4 // gcd(J, 4)
# does not divide S = 5 or 33.
_K3_CASES = {
    "S5 J9 C6": (5, 9, 6, None),
    "S5 J9 C6 bands of 4": (5, 9, 6, 4),
    "S8 J12 C4": (8, 12, 4, None),
    "S8 J12 C4 bands of 8": (8, 12, 4, 8),
    "S33 J3 C4": (33, 3, 4, None),
    "S8 J3 C2": (8, 3, 2, None),
}


@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("case", list(_K3_CASES))
def test_k3_tiling_matches_plain_and_jax(case, half):
    s, j, c, band = _K3_CASES[case]
    rng = np.random.default_rng(s * j * c + (band or 0))
    lhs_t = rng.standard_normal((4, j * s, c)).astype(F32)
    lhs_t[:, :s] = 0.0  # row a = 0 of the edge factors is zero by construction
    rhs = rng.standard_normal((4, c, s * j)).astype(F32)
    c0 = rng.standard_normal((4, s, s * j)).astype(F32)
    g, plan_band = skew_plan(j, c)
    assert (g * j) % 4 == 0 and plan_band % 4 == 0 and plan_band >= j
    got = _emulate_k3(lhs_t, rhs, c0, j, half, g, band or plan_band)
    assert not np.isnan(got).any()
    plain = K.lag_skew_assemble_plain(*(torch.from_numpy(x) for x in (lhs_t, rhs, c0)), j,
                                      half).numpy()
    want = np.asarray(lag_skew_assemble(jnp.asarray(lhs_t), jnp.asarray(rhs), jnp.asarray(c0),
                                        j, interpret=True, half_scaled=half))
    t2, t1 = np.arange(s * j) % j, np.arange(j)
    upper = np.broadcast_to(t2[None, :] > t1[:, None], got.shape)
    assert np.all(got[upper] == 0.0) and np.all(plain[upper] == 0.0)
    assert _rel(got, plain) <= TOL
    # The JAX full form leaves garbage in the strict-upper-tap lanes.
    assert _rel(got[~upper], want[~upper]) <= TOL


def test_k3_plan_walks_bands_where_the_tile_does_not_fit():
    """J x J tiles that outgrow the preferred shared memory are walked in
    narrower bands; past 227 KB even for 4-row bands the wrapper names the
    limit."""
    g, band = skew_plan(1000, 34)
    assert g == 1 and 4 <= band < 1000 and band % 4 == 0
    assert skew_plan(50, 34) == (2, 52) and skew_plan(50, 66) == (2, 52)
    assert skew_plan(100, 18) == (1, 100)
    with pytest.raises(ValueError, match="227 KB"):
        skew_plan(2000, 30)


# ---- K5 and K11 -------------------------------------------------------------

_ROWS = _source_constant("output_filter", "kRows")
_SAMPLES = _source_constant("output_filter", "kSamples")
_WARPS = _source_constant("output_filter", "kWarps")


def _emulate_k5(x, filt, window, tail, hop, overlap=True):
    """K5's (K11's without ``overlap``) blocks one by one; unwritten
    outputs stay NaN."""
    z, block = x.shape
    rows, taps = filt.shape[1:]
    row_tile, sample_tile = _ROWS * _WARPS, _SAMPLES * 32
    taps4 = -(-taps // 4) * 4
    pad = taps4 - 1
    bh = block - hop
    emit = np.full((z, rows, hop if overlap else block), np.nan, F32)
    new_tail = np.full((z, rows, bh), np.nan, F32)
    lane = np.arange(32)
    for zz in range(z):
        for r0 in range(0, rows, row_tile):
            nr = min(row_tile, rows - r0)
            fs = np.zeros((row_tile, taps4), F32)
            fs[:nr, :taps] = filt[zz, r0:r0 + nr]
            for n0 in range(0, block, sample_tile):
                es = x[zz, (n0 - pad + np.arange(sample_tile + taps4)) % block]
                ts = np.zeros((row_tile, sample_tile), F32)
                nt = max(0, min(sample_tile, bh - n0))
                ts[:nr, :nt] = tail[zz, r0:r0 + nr, n0:n0 + nt] if overlap else 0.0
                acc = np.zeros((row_tile, 32, _SAMPLES), F32)  # (warp*8 + i, lane, s)
                for t0 in range(0, taps, 4):
                    win = es[4 * lane[:, None] + pad - 3 - t0 + np.arange(8)[None, :]]
                    for k in range(min(4, taps - t0)):
                        for s in range(_SAMPLES):
                            acc[:, :, s] = _fma(fs[:, t0 + k][:, None], win[None, :, 3 + s - k],
                                                acc[:, :, s])
                acc = acc.reshape(row_tile, sample_tile)  # sample n0 + 4 lane + s
                n = n0 + np.arange(sample_tile)
                keep = n < block
                if not overlap:
                    emit[zz, r0:r0 + nr][:, n[keep]] = acc[:nr, keep]
                    continue
                v = ((acc * window[n % block]).astype(F32) + ts).astype(F32)
                e, t = keep & (n < hop), keep & (n >= hop)
                emit[zz, r0:r0 + nr][:, n[e]] = v[:nr, e]
                new_tail[zz, r0:r0 + nr][:, n[t] - hop] = v[:nr, t]
    return (emit, new_tail) if overlap else emit


# (block, rows, taps, hop, overlap): hop below, at and above block - hop;
# ragged row and sample tiles; taps with and without a guarded last step.
_K5_CASES = {
    "hop < block-hop": (100, 37, 9, 30, True),
    "hop = block-hop": (64, 12, 16, 32, True),
    "hop > block-hop": (100, 37, 9, 60, True),
    "hop > block-hop, 7 taps": (48, 5, 7, 36, True),
    "3 x 3 tiles": (300, 70, 13, 100, True),
    "K11": (300, 70, 13, None, False),
}


@pytest.mark.parametrize("case", list(_K5_CASES))
def test_k5_tiling_matches_plain_and_jax(case):
    block, rows, taps, hop, overlap = _K5_CASES[case]
    rng = np.random.default_rng(block + rows + taps)
    x, filt = rng.standard_normal((2, block)).astype(F32), rng.standard_normal((2, rows, taps)).astype(F32)
    if not overlap:
        got = _emulate_k5(x, filt, None, None, block, overlap=False)
        plain = K.circular_filter_plain(torch.from_numpy(x), torch.from_numpy(filt)).numpy()
        want = np.asarray(circular_filter_pallas(jnp.asarray(x), jnp.asarray(filt),
                                                 interpret=True))
        assert not np.isnan(got).any()
        assert _rel(got, plain) <= TOL and _rel(got, want) <= TOL
        return
    window = rng.standard_normal(block).astype(F32)
    tail = rng.standard_normal((2, rows, block - hop)).astype(F32)
    got = _emulate_k5(x, filt, window, tail, hop)
    plain = K.circular_filter_overlap(*(torch.from_numpy(a) for a in (x, filt, window, tail)), hop)
    want = circular_filter_overlap_pallas(jnp.asarray(x), jnp.asarray(filt), jnp.asarray(window),
                                          jnp.asarray(tail), hop, interpret=True)
    for g, p, w in zip(got, plain, want):
        assert not np.isnan(g).any() and g.shape == tuple(p.shape)
        assert _rel(g, p.numpy()) <= TOL and _rel(g, w) <= TOL
