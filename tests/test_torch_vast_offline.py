"""The port's offline VAST designs against the JAX package's, on the CPU,
in float64 at the sizes of ``tests/test_vast_offline.py``: statistics
(with the ``num_steps`` truncation), designs, endpoints, the mu sweep and
the synthesis helpers, each within 1e-9 of the JAX result's scale (the
same algorithm; only rounding separates them). The JAX side is held to a
direct re-enactment of the reference's accumulation loop in its own
tests."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch import vast_offline as vast_offline_export
from apvast_torch.ops.synthesis import spans_from_family, variable_span_filters_mu_grid
from apvast_tpu.ops.synthesis import spans_from_family as jax_spans_from_family
from apvast_tpu.ops.synthesis import (
    variable_span_filters_mu_grid as jax_variable_span_filters_mu_grid,
)
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# The modules (each package's models/__init__ exports the function of the
# same name).
tv = importlib.import_module("apvast_torch.models.vast_offline")
jv = importlib.import_module("apvast_tpu.models.vast_offline")

TOL = 1e-9


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _decaying(rng, rl, s, m):
    return rng.standard_normal((rl, s, m)) * np.exp(-np.arange(rl) / 10)[:, None, None]


# (rl, s, m, j, delay, ref, steps): the JAX tests' sizes; 20 steps truncate
# the lags (steps < rl + j - 1), 200 pad past the RIRs.
_STAT_CASES = {
    "loop-size": (24, 2, 2, 6, 3, 1, 40),
    "truncated": (30, 1, 1, 8, 2, 0, 20),
    "padded": (30, 2, 3, 6, 4, 1, 200),
    "delay-past-steps": (30, 2, 2, 6, 25, 0, 20),
}


@pytest.mark.parametrize("case", list(_STAT_CASES))
def test_statistics_match_jax(case):
    rl, s, m, j, delay, ref, steps = _STAT_CASES[case]
    rng = np.random.default_rng(1)
    rir_b, rir_d = rng.standard_normal((rl, s, m)), rng.standard_normal((rl, s, m))
    got = tv.vast_statistics(rir_b, rir_d, j, delay, ref, steps, device="cpu")
    want = jv.vast_statistics(jnp.asarray(rir_b), jnp.asarray(rir_d), j, delay, ref, steps)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel(g, w) <= TOL
    frames = tv._lagged_rir_frames(torch.from_numpy(rir_b), j, steps)
    assert _rel(frames, jv._lagged_rir_frames(jnp.asarray(rir_b), j, steps)) == 0.0


def test_designs_match_jax():
    """``vast_offline`` (filters and family), ``acc`` and
    ``pressure_matching`` on the JAX endpoint test's decaying RIRs."""
    rng = np.random.default_rng(2)
    rl, s, m, j = 40, 3, 2, 8
    rir_b, rir_d = _decaying(rng, rl, s, m), _decaying(rng, rl, s, m)
    jb, jd = jnp.asarray(rir_b), jnp.asarray(rir_d)
    family = tv.vast_offline(rir_b, rir_d, j, 2, 0, num_eigenvectors=j * s, mu=1.0,
                             num_steps=80, reg=1e-10, return_family=True, device="cpu")
    want = jv.vast_offline(jb, jd, j, 2, 0, num_eigenvectors=j * s, mu=1.0, num_steps=80,
                           reg=1e-10, return_family=True)
    assert family.shape == (j * s, j, s) and _rel(family, want) <= TOL
    single = vast_offline_export(rir_b, rir_d, j, 2, 1, num_eigenvectors=5, mu=0.7,
                                 num_steps=80, reg=1e-10, device="cpu")
    want = jv.vast_offline(jb, jd, j, 2, 1, num_eigenvectors=5, mu=0.7, num_steps=80,
                           reg=1e-10)
    assert single.shape == (j, s) and _rel(single, want) <= TOL
    got = tv.acc(rir_b, rir_d, j, 2, 0, num_steps=80, reg=1e-10, device="cpu")
    assert _rel(got, jv.acc(jb, jd, j, 2, 0, num_steps=80, reg=1e-10)) <= TOL
    got = tv.pressure_matching(rir_b, rir_d, j, 2, 0, num_steps=80, reg=1e-10, device="cpu")
    assert _rel(got, jv.pressure_matching(jb, jd, j, 2, 0, num_steps=80, reg=1e-10)) <= TOL


def test_sweep_matches_jax_and_single_designs():
    rng = np.random.default_rng(3)
    rl, s, m, j = 30, 2, 2, 6
    rir_b, rir_d = rng.standard_normal((rl, s, m)), rng.standard_normal((rl, s, m))
    mu_grid = np.array([0.3, 1.0, 3.0])
    surface = tv.vast_offline_sweep(rir_b, rir_d, j, 2, 1, num_eigenvectors=j * s,
                                    mu_grid=mu_grid, num_steps=40, reg=1e-10, device="cpu")
    want = jv.vast_offline_sweep(jnp.asarray(rir_b), jnp.asarray(rir_d), j, 2, 1,
                                 num_eigenvectors=j * s, mu_grid=mu_grid, num_steps=40,
                                 reg=1e-10)
    assert surface.shape == (3, j * s, j, s) and _rel(surface, want) <= TOL
    for gi, mu in enumerate(mu_grid):
        single = tv.vast_offline(rir_b, rir_d, j, 2, 1, num_eigenvectors=j * s, mu=float(mu),
                                 num_steps=40, reg=1e-10, return_family=True, device="cpu")
        torch.testing.assert_close(surface[gi], single, rtol=1e-9, atol=1e-11)


def test_synthesis_helpers_match_jax():
    rng = np.random.default_rng(4)
    jl, v = 12, 5
    u, lam, r = rng.standard_normal((jl, jl)), np.sort(rng.random(jl))[::-1].copy(), \
        rng.standard_normal(jl)
    mu_grid = np.array([0.1, 1.0, 10.0, 100.0])
    got = variable_span_filters_mu_grid(torch.from_numpy(u), torch.from_numpy(lam),
                                        torch.from_numpy(r), torch.from_numpy(mu_grid), v)
    want = jax_variable_span_filters_mu_grid(jnp.asarray(u), jnp.asarray(lam), jnp.asarray(r),
                                             jnp.asarray(mu_grid), v)
    assert got.shape == (4, v, jl) and _rel(got, want) <= TOL
    family = got[1]
    spans = [1, 3, 5]
    picked = spans_from_family(family, spans)
    assert torch.equal(picked, family[[0, 2, 4]])
    assert _rel(picked, jax_spans_from_family(jnp.asarray(family.numpy()), spans)) == 0.0


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    rir = np.zeros((10, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        tv.vast_offline(rir, rir, 2, 0, 0, num_eigenvectors=1, mu=1.0, num_steps=8)
