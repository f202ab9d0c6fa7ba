"""The plain PyTorch version of each ported kernel (K1, K2, K3 in both
forms, K5; K4 is in tests/test_torch_jacobi.py) against
the JAX Pallas function it replaces, run in interpret mode, and against a
float64 NumPy oracle — at small shapes, ragged ones included (source
counts that are not a multiple of 8, row counts that fill no tile).

On the CPU every wrapper takes its plain version, so these tests also
pin the wrappers' input checks and that a CPU tensor launches nothing.

Tolerances: the plain versions and the interpret-mode Pallas functions
both compute in float32 with sums taken in another order, so they agree
to 1e-5 of the output scale; the float64 oracle sits within 1e-5 of both
(float32 rounding of sums of at most a few thousand terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_torch.ops.lag_statistics import covariance_via_lags_skew
from apvast_tpu.ops.lag_statistics import (
    covariance_via_lags_skew as jax_covariance_via_lags_skew,
)
from apvast_tpu.ops.pallas.lag_corr import lag_corr_pallas
from apvast_tpu.ops.pallas.output_filter import circular_filter_overlap_pallas
from apvast_tpu.ops.pallas.skew_assembly import lag_skew_assemble
from apvast_tpu.ops.pallas.streaming_conv import streaming_conv_pallas
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---- K1 streaming convolution --------------------------------------------


def _conv_oracle(seg, kern, hop):
    seg, kern = seg.astype(np.float64), kern.astype(np.float64)
    taps = kern.shape[-1]
    hist = seg.shape[-1] - hop
    idx = hist + np.arange(hop)[None, :] - np.arange(taps)[:, None]  # (taps, hop)
    return np.einsum("zrk,zkh->zrh", kern, seg[:, idx])


@pytest.mark.parametrize(
    "z,seg_len,rows,taps,hop",
    [(2, 300, 37, 77, 50), (2, 256, 27, 120, 64), (1, 100, 5, 51, 50)],
)
def test_streaming_conv_plain(z, seg_len, rows, taps, hop):
    rng = np.random.default_rng(seg_len + rows)
    seg, kern = _f32(rng, z, seg_len), _f32(rng, z, rows, taps)
    got = K.streaming_conv(torch.from_numpy(seg), torch.from_numpy(kern), hop)
    assert got.shape == (z, rows, hop) and got.dtype == torch.float32
    want = streaming_conv_pallas(jnp.asarray(seg), jnp.asarray(kern), hop, interpret=True)
    assert _rel(got, want) <= TOL
    assert _rel(got, _conv_oracle(seg, kern, hop)) <= TOL


# ---- K2 lag correlations --------------------------------------------------


def _lag_oracle(x, j):
    x = x.astype(np.float64)
    k = x.shape[-1] - j + 1
    shifted = np.stack([x[..., l : l + k] for l in range(j)], axis=-2)
    return np.einsum("pmst,pmult->psul", x[..., :k], shifted)


@pytest.mark.parametrize(
    "m,s,n,j", [(3, 5, 70, 9), (2, 9, 60, 12), (1, 4, 33, 1), (2, 33, 80, 40)]
)
def test_lag_corr_plain(m, s, n, j):
    rng = np.random.default_rng(n + s)
    x = _f32(rng, 4, m, s, n)
    got = K.lag_corr(torch.from_numpy(x), j)
    assert got.shape == (4, s, s, j)
    # interpret=True keeps the Pallas shift stack in float32.
    want = lag_corr_pallas(jnp.asarray(x), j, interpret=True)
    assert _rel(got, want) <= TOL
    assert _rel(got, _lag_oracle(x, j)) <= TOL


# ---- K3 skew assembly -----------------------------------------------------


def _skew_inputs(rng, s, j, c):
    return _f32(rng, 4, j * s, c), _f32(rng, 4, c, s * j), _f32(rng, 4, s, s * j)


def _valid_lanes(s, j):
    """(J, S*J) mask of the lanes t2 <= t1 of row band t1."""
    t2 = np.arange(s * j) % j
    return t2[None, :] <= np.arange(j)[:, None]


def _skew_oracle(lhs_t, rhs_sm, c0_sm, j):
    """out[p, s1, J-1-a, w] = c0_sm[w + a] + sum_{i<=a} T_i[w + a - i] on the
    valid lanes, T_i = lhsT[i] @ rhs, all in float64."""
    p, js, c = lhs_t.shape
    s = js // j
    w = rhs_sm.shape[-1]
    terms = np.einsum(
        "pasc,pcw->pasw", lhs_t.reshape(p, j, s, c).astype(np.float64),
        rhs_sm.astype(np.float64),
    )
    out = np.zeros((p, s, j, w))
    for a in range(j):
        for lane in range(w):
            if lane % j + a > j - 1:
                continue
            acc = c0_sm[:, :, lane + a].astype(np.float64)
            for i in range(a + 1):
                acc = acc + terms[:, i, :, lane + a - i]
            out[:, :, j - 1 - a, lane] = acc
    return out


@pytest.mark.parametrize("s,j,c", [(5, 9, 6), (3, 7, 4), (9, 4, 2)])
def test_skew_assembly_plain(s, j, c):
    rng = np.random.default_rng(s * j + c)
    lhs_t, rhs_sm, c0_sm = _skew_inputs(rng, s, j, c)
    lhs_t[:, :s] = 0.0  # row a = 0 of the edge factors is zero by construction
    got = K.lag_skew_assemble(
        torch.from_numpy(lhs_t), torch.from_numpy(rhs_sm), torch.from_numpy(c0_sm), j
    ).numpy()
    assert got.shape == (4, s, j, s * j)
    valid = _valid_lanes(s, j)[None, None]
    # The strict upper-tap lanes are zero (the Pallas kernel leaves garbage).
    assert np.all(got[np.broadcast_to(~valid, got.shape)] == 0.0)
    want = np.asarray(
        lag_skew_assemble(
            jnp.asarray(lhs_t), jnp.asarray(rhs_sm), jnp.asarray(c0_sm), j,
            interpret=True,
        )
    )
    mask = np.broadcast_to(valid, got.shape)
    assert _rel(got[mask], want[mask]) <= TOL
    assert _rel(got[mask], _skew_oracle(lhs_t, rhs_sm, c0_sm, j)[mask]) <= TOL


@pytest.mark.parametrize("s,j,c", [(5, 9, 6), (3, 7, 4), (9, 4, 2)])
def test_skew_assembly_half_plain(s, j, c):
    """The half form M (R = M + M^T): strict-upper-tap lanes zero and
    tap-diagonal lanes halved, against the Pallas function with
    ``half_scaled=True`` (which zeroes those lanes too) and the float64
    oracle."""
    rng = np.random.default_rng(100 + s * j + c)
    lhs_t, rhs_sm, c0_sm = _skew_inputs(rng, s, j, c)
    lhs_t[:, :s] = 0.0
    got = K.lag_skew_assemble(
        torch.from_numpy(lhs_t), torch.from_numpy(rhs_sm), torch.from_numpy(c0_sm), j,
        half_scaled=True,
    ).numpy()
    want = np.asarray(
        lag_skew_assemble(
            jnp.asarray(lhs_t), jnp.asarray(rhs_sm), jnp.asarray(c0_sm), j,
            interpret=True, half_scaled=True,
        )
    )
    assert _rel(got, want) <= TOL
    t2 = np.arange(s * j) % j
    scale = np.where(t2[None, :] == np.arange(j)[:, None], 0.5, 1.0)
    oracle = _skew_oracle(lhs_t, rhs_sm, c0_sm, j) * scale
    assert _rel(got, oracle) <= TOL
    assert np.all(got[np.broadcast_to(~_valid_lanes(s, j)[None, None], got.shape)] == 0.0)


@pytest.mark.parametrize("s", [3, 8])
def test_skew_statistics_half_form(s):
    """form="half" returns M with M + M^T equal to the full-form R, the
    JAX half form, and the float64 dense Gram after completion."""
    rng = np.random.default_rng(60 + s)
    m, n, j = 2, 50, 6
    k = n - j + 1
    buf, d = 1e-2 * _f32(rng, 4, m, s, n), 1e-2 * _f32(rng, 2, m, k)
    tb, td = torch.from_numpy(buf), torch.from_numpy(d)
    half, r_half = covariance_via_lags_skew(tb, td, j, form="half")
    full, r_full = covariance_via_lags_skew(tb, td, j)
    jm, jv = jax_covariance_via_lags_skew(jnp.asarray(buf), jnp.asarray(d), j, form="half")
    assert _rel(half, jm) <= TOL and _rel(r_half, jv) <= TOL
    torch.testing.assert_close(r_half, r_full, rtol=0, atol=0)
    assert _rel(half + half.transpose(-1, -2), full) <= TOL
    frames = np.stack([buf[..., t : t + k] for t in range(j)], axis=-1)
    y = frames[..., ::-1].transpose(0, 1, 2, 4, 3).reshape(4, m, s * j, k).astype(np.float64)
    assert _rel(half + half.transpose(-1, -2), np.einsum("pmak,pmbk->pab", y, y)) <= TOL
    with pytest.raises(ValueError, match="form"):
        covariance_via_lags_skew(tb, td, j, form="quarter")


@pytest.mark.parametrize("s", [3, 8])
def test_skew_statistics_after_completion(s):
    """The completed (R, r) of the skew path equal the JAX path's and the
    float64 dense Gram of the framed buffers."""
    rng = np.random.default_rng(40 + s)
    m, n, j = 2, 50, 6
    k = n - j + 1
    buf, d = 1e-2 * _f32(rng, 4, m, s, n), 1e-2 * _f32(rng, 2, m, k)
    r_mats, r_vecs = covariance_via_lags_skew(torch.from_numpy(buf), torch.from_numpy(d), j)
    jr, jv = jax_covariance_via_lags_skew(jnp.asarray(buf), jnp.asarray(d), j)
    assert _rel(r_mats, jr) <= TOL and _rel(r_vecs, jv) <= TOL
    frames = np.stack([buf[..., t : t + k] for t in range(j)], axis=-1)  # (4,m,s,k,j)
    y = frames[..., ::-1].transpose(0, 1, 2, 4, 3).reshape(4, m, s * j, k)
    y = y.astype(np.float64)
    assert _rel(r_mats, np.einsum("pmak,pmbk->pab", y, y)) <= TOL
    assert _rel(r_vecs, np.einsum("zmak,zmk->za", y[[0, 3]], d)) <= TOL


# ---- K5 circular filter + window + overlap-add ---------------------------


def _filter_oracle(x, filt, window, tail, hop):
    x, filt = x.astype(np.float64), filt.astype(np.float64)
    block, taps = x.shape[-1], filt.shape[-1]
    idx = (np.arange(block)[None, :] - np.arange(taps)[:, None]) % block
    y = np.einsum("zrt,ztn->zrn", filt, x[:, idx]) * window
    bh = block - hop
    v = y + np.pad(tail.astype(np.float64), ((0, 0), (0, 0), (0, block - bh)))
    return v[..., :hop], v[..., hop:]


@pytest.mark.parametrize(
    "block,rows,taps,hop",
    [(100, 37, 9, 30), (100, 37, 9, 60), (64, 12, 16, 32), (48, 5, 7, 36)],
)
def test_output_filter_plain(block, rows, taps, hop):
    """Both branches of the TPU kernel: hop < block - hop and hop >=
    block - hop."""
    rng = np.random.default_rng(block + rows + hop)
    x, filt = _f32(rng, 2, block), _f32(rng, 2, rows, taps)
    window, tail = _f32(rng, block), _f32(rng, 2, rows, block - hop)
    got = K.circular_filter_overlap(*(torch.from_numpy(a) for a in (x, filt, window, tail)), hop)
    want = circular_filter_overlap_pallas(
        jnp.asarray(x), jnp.asarray(filt), jnp.asarray(window), jnp.asarray(tail),
        hop, interpret=True,
    )
    oracle = _filter_oracle(x, filt, window, tail, hop)
    for g, w, o in zip(got, want, oracle):
        assert g.shape == w.shape
        if g.numel():
            assert _rel(g, w) <= TOL and _rel(g, o) <= TOL


# ---- wrappers ------------------------------------------------------------


def test_cpu_tensors_launch_nothing():
    K.reset_launch_counts()
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(_f32(rng, *s))  # noqa: E731
    K.streaming_conv(t(2, 100), t(2, 3, 20), 40)
    K.lag_corr(t(4, 2, 3, 30), 5)
    K.lag_skew_assemble(t(4, 15, 4), t(4, 4, 15), t(4, 3, 15), 5)
    K.lag_skew_assemble(t(4, 15, 4), t(4, 4, 15), t(4, 3, 15), 5, half_scaled=True)
    K.jacobi_eigh(t(2, 6, 6), 2)
    K.circular_filter_overlap(t(2, 32), t(2, 3, 4), t(32), t(2, 3, 16), 16)
    assert K.launch_counts() == {name: 0 for name in K.WRAPPERS}


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda: K.lag_corr(torch.zeros(4, 2, 3, 30, dtype=torch.float64), 5), ValueError),
        (lambda: K.lag_corr(torch.zeros(2, 3, 30), 5), ValueError),
        (lambda: K.lag_corr(torch.zeros(4, 2, 30, 3).transpose(-1, -2), 5), ValueError),
        (lambda: K.streaming_conv(torch.zeros(2, 30), torch.zeros(2, 3, 20), 20), ValueError),
        (lambda: K.streaming_conv(torch.zeros(2, 100), torch.zeros(1, 3, 20), 40), ValueError),
        (lambda: K.lag_skew_assemble(torch.zeros(4, 14, 4), torch.zeros(4, 4, 15),
                                     torch.zeros(4, 3, 15), 5), ValueError),
        (lambda: K.circular_filter_overlap(torch.zeros(2, 32), torch.zeros(2, 3, 4),
                                           torch.zeros(32), torch.zeros(2, 3, 15), 16),
         ValueError),
        (lambda: K.streaming_conv(np.zeros((2, 100), np.float32),
                                  torch.zeros(2, 3, 20), 40), TypeError),
    ],
    ids=["float64", "ndim", "noncontiguous", "short-history", "signals",
         "lhs-rows", "tail-shape", "not-a-tensor"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(call, error):
    with pytest.raises(error):
        call()
