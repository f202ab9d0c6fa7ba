"""The kept lag assemblies ("pair", "tap", "wide") and the full-window
correlations' ``c0_method`` variants (``apvast_torch/ops/lag_statistics.py``)
against the JAX package's functions on the same float64 inputs, and the
engine's dispatch (``engine/hop.py``: each assembly in the hop, the
tap-major filter extraction) against the JAX engine.

The cases mirror ``tests/test_lag_statistics.py`` (``:35``, ``:76``,
``:101``, ``:116``, ``:138``, ``:191``, ``:227``): every variant computes
the dense Gram's sums in another order, so float64 agreement is near
machine precision, and the tap-major pencil is the symmetric permutation
of the source-major one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.engine import build_plan, process_hop
from apvast_torch.ops import kernels as K
from apvast_torch.ops import lag_statistics as L
from apvast_torch.ops.framing import frame_buffer
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_tpu.config import ToeplitzVariant
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from apvast_tpu.ops import lag_statistics as JL
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

_SHAPES = [(3, 16, 2, 80), (4, 7, 3, 40), (2, 1, 2, 12)]


def _inputs(seed, s, j, m, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, m, s, n)).astype(dtype),
            rng.standard_normal((2, m, n - j + 1)).astype(dtype))


def _dense_gram(buf, d, j):
    """The hop's framed-einsum statistics, contiguous framing."""
    frames = frame_buffer(buf, j)
    p, m, s, k, _ = frames.shape
    y = frames.flip(-1).permute(0, 1, 2, 4, 3).reshape(p, m, s * j, k)
    return torch.einsum("pmak,pmbk->pab", y, y), torch.einsum("zmak,zmk->za", y[0::3], d)


def _close(got, want, tol=1e-11):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("c0_method", ["conv", "matmul", "fft"])
@pytest.mark.parametrize("s,j,m,n", _SHAPES)
def test_pair_matches_jax_and_the_dense_gram_float64(c0_method, s, j, m, n):
    buf, d = _inputs(11 + s + j, s, j, m, n)
    got_r, got_v = L.covariance_via_lags(torch.from_numpy(buf), torch.from_numpy(d), j,
                                         c0_method=c0_method)
    want_r, want_v = JL.covariance_via_lags(jnp.asarray(buf), jnp.asarray(d), j,
                                            c0_method=c0_method)
    _close(got_r, want_r)
    _close(got_v, want_v)
    gram_r, gram_v = _dense_gram(torch.from_numpy(buf), torch.from_numpy(d), j)
    _close(got_r, gram_r)
    _close(got_v, gram_v)


def test_pair_float32_matches_the_dense_gram():
    """float32, "auto" (conv off the card), JAX's float32 bar."""
    buf, d = _inputs(3, 3, 20, 2, 120, np.float32)
    got_r, got_v = L.covariance_via_lags(torch.from_numpy(buf), torch.from_numpy(d), 20)
    want_r, want_v = _dense_gram(torch.from_numpy(buf).double(), torch.from_numpy(d).double(), 20)
    for got, want in ((got_r, want_r), (got_v, want_v)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("s,j,m,n", _SHAPES)
def test_tap_major_is_permuted_source_major(s, j, m, n):
    """``covariance_via_lags_tap`` against JAX's, and against the (s, t) ->
    (t, s) permutation of the source-major statistics."""
    buf, d = _inputs(21 + s + j, s, j, m, n)
    tb, td = torch.from_numpy(buf), torch.from_numpy(d)
    r_tap, v_tap = L.covariance_via_lags_tap(tb, td, j, c0_method="conv")
    want_r, want_v = JL.covariance_via_lags_tap(jnp.asarray(buf), jnp.asarray(d), j,
                                                c0_method="conv")
    _close(r_tap, want_r)
    _close(v_tap, want_v)
    r_src, v_src = L.covariance_via_lags(tb, td, j, c0_method="conv")
    perm = r_src.reshape(4, s, j, s, j).permute(0, 2, 1, 4, 3).reshape(4, s * j, s * j)
    _close(r_tap, perm, 1e-12)
    _close(v_tap, v_src.reshape(2, s, j).transpose(1, 2).reshape(2, s * j), 1e-12)


def test_tap_major_matrices_symmetric():
    buf, d = _inputs(5, 3, 10, 2, 60)
    r_tap, _ = L.covariance_via_lags_tap(torch.from_numpy(buf), torch.from_numpy(d), 10,
                                         c0_method="conv")
    np.testing.assert_allclose(r_tap.numpy(), r_tap.transpose(-1, -2).numpy(), rtol=0,
                               atol=1e-12 * float(r_tap.abs().max()))


def test_wide_equals_pair_assembly():
    """``covariance_via_lags_wide``: the pair assembly's values in its
    source-major order, and JAX's wide assembly."""
    buf, d = _inputs(31, 4, 9, 3, 70)
    tb, td = torch.from_numpy(buf), torch.from_numpy(d)
    r_pair, v_pair = L.covariance_via_lags(tb, td, 9, c0_method="conv")
    r_wide, v_wide = L.covariance_via_lags_wide(tb, td, 9, c0_method="conv")
    _close(r_wide, r_pair, 1e-12)
    np.testing.assert_array_equal(v_wide.numpy(), v_pair.numpy())
    want_r, _ = JL.covariance_via_lags_wide(jnp.asarray(buf), jnp.asarray(d), 9,
                                            c0_method="conv")
    _close(r_wide, want_r)


@pytest.mark.parametrize("s,j,m,n", _SHAPES)
def test_skew_equals_pair_assembly(s, j, m, n):
    """The skew assembly (K3, float32; C0 by conv or K2's plain version)
    against the JAX package's pair assembly in float64, at float32's
    rounding, and exactly symmetric."""
    buf, d = _inputs(41 + s + j, s, j, m, n)
    want_r, want_v = JL.covariance_via_lags(jnp.asarray(buf), jnp.asarray(d), j, c0_method="conv")
    tb, td = torch.from_numpy(buf).float(), torch.from_numpy(d).float()
    for c0_method in ("conv", "pallas"):
        r_skew, v_skew = L.covariance_via_lags_skew(tb, td, j, c0_method=c0_method)
        _close(r_skew, want_r, 2e-5)
        _close(v_skew, want_v, 2e-5)
        np.testing.assert_array_equal(r_skew.numpy(), r_skew.transpose(-1, -2).numpy())


@pytest.mark.parametrize("assembly", ["pair", "wide", "tap"])
@pytest.mark.parametrize("variant", list(ToeplitzVariant))
def test_engine_hop_with_lag_statistics(small_scene, variant, assembly):
    """``process_hop`` with each kept assembly against the JAX engine's, both
    Toeplitz variants, float64, three hops from one state: the tap-major
    hop extracts its filters (J, S)."""
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, toeplitz_variant=variant, use_lag_statistics=True,
                             lag_assembly=assembly)
    tc = config_from_jax(dataclasses.asdict(jc))
    jplan, jstate = jax_build_plan(jc, rir_a, rir_b), jax_init_state(jc, key=jax.random.key(0))
    plan = build_plan(tc, rir_a, rir_b, "cpu")
    state = state_from_numpy(tc, {f.name: None if getattr(jstate, f.name) is None
                                  else np.asarray(getattr(jstate, f.name))
                                  for f in dataclasses.fields(jstate)}, "cpu")
    jax_hop = jax.jit(lambda s, a, b: jax_process_hop(jc, jplan, s, a, b))
    rng = np.random.default_rng(8)
    for _ in range(3):
        a, b = rng.standard_normal(tc.hop), rng.standard_normal(tc.hop)
        state, out = process_hop(tc, plan, state, torch.from_numpy(a), torch.from_numpy(b))
        jstate, jout = jax_hop(jstate, jnp.asarray(a), jnp.asarray(b))
        for name in ("out_a", "out_b"):
            _close(getattr(out, name), getattr(jout, name), 1e-9)


@pytest.mark.parametrize("n", [60, 61])  # odd and even buffer lengths
def test_fft_c0_matches_matmul(n):
    """The half-spectrum DFT correlations against the shift-stack matmul
    (the even length's Nyquist fold weight included), and against JAX's."""
    rng = np.random.default_rng(17)
    buf = rng.standard_normal((4, 3, 4, n))
    got = L._c0_fft(torch.from_numpy(buf), 9)
    _close(got, L._c0_matmul(torch.from_numpy(buf), n - 8), 1e-12)
    _close(got, JL._c0_fft(jnp.asarray(buf), 9), 1e-12)


def test_c0_methods_dispatch():
    """"pallas" is K2 (its plain version on the CPU), "auto" takes conv off
    the card, and an unknown method raises JAX's ValueError."""
    buf = torch.from_numpy(np.random.default_rng(13).standard_normal((4, 3, 4, 60))
                           .astype(np.float32))
    K.reset_launch_counts()
    want = L._c0_conv(buf, 52)
    for method in ("pallas", "auto", "conv", "matmul", "fft"):
        np.testing.assert_allclose(L._compute_c0(buf, 9, method).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(L._compute_c0(buf, 9, "pallas"), K.lag_corr_plain(buf, 9))
    with pytest.raises(ValueError) as jax_err:
        JL._compute_c0(jnp.asarray(buf.numpy()), 9, "bogus")
    with pytest.raises(ValueError) as torch_err:
        L._compute_c0(buf, 9, "bogus")
    assert str(torch_err.value) == str(jax_err.value)
