"""The port's hop against the JAX engine's, hop by hop, on the CPU.

1. Float64 parity on the default configuration (dense framed statistics,
   FFT convolution and synthesis, exact GEVD) and variants of it: <= 1e-9
   of each output's scale over 6 hops. The JAX side is within 1e-9 of the
   live reference (tests/test_true_reference_parity.py), and both sides
   run the same float64 algorithm, so only rounding separates them.
2. The slice configuration in float32 (production values with the exact
   solver, perceptual weighting on) at S=4 and S=8, against JAX with its
   Pallas kernels in interpret mode. The statistics (R, r) that feed the
   GEVD are compared tightly (1e-4 of their scale: float32 sums in another
   order); the GEVD of a near-degenerate pencil amplifies that rounding,
   so the loudspeaker feeds are compared at signal scale (5e-2 of the
   largest feed sample) and the target feeds, which bypass the GEVD, to
   1e-5.
3. Carry-over: a JAX state taken part-way through a stream and carried
   across with ``utils/convert.py`` gives the same next hop in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.engine import build_plan, hop_statistics, init_state, process_hop
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_tpu.config import (
    ApVastConfig,
    GevdSolver,
    TargetFilterVariant,
    ToeplitzVariant,
    production_overrides,
)
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from apvast_tpu.ops.lag_statistics import covariance_via_lags_skew
from apvast_tpu.utils.rir import synthetic_rirs
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class _Pair:
    """The same scene, noise and hops through the JAX engine and the port."""

    def __init__(self, jc, rir_a, rir_b, seed=3):
        self.jc = jc
        self.tc = config_from_jax(dataclasses.asdict(jc))
        self.rng = np.random.default_rng(seed)
        m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
        noise = (
            1e-3 * self.rng.standard_normal((4, m, s, block)),
            1e-3 * self.rng.standard_normal((2, m, block)),
        )
        self.jplan = jax_build_plan(jc, rir_a, rir_b)
        self.jstate = jax_init_state(jc, response_noise=noise)
        self.plan = build_plan(self.tc, rir_a, rir_b, device="cpu")
        self.state = init_state(self.tc, device="cpu", response_noise=noise)
        self._jhop = jax.jit(lambda st, a, b: jax_process_hop(jc, self.jplan, st, a, b))
        self.dtype = np.dtype(jc.dtype)

    def inputs(self):
        return tuple(
            self.rng.standard_normal(self.jc.hop).astype(self.dtype) for _ in range(2)
        )

    def step(self, a, b):
        self.jstate, jout = self._jhop(self.jstate, jnp.asarray(a), jnp.asarray(b))
        self.state, out = process_hop(
            self.tc, self.plan, self.state, torch.from_numpy(a), torch.from_numpy(b)
        )
        assert int(out.silenced) == 0 and int(jout.silenced) == 0
        return (
            [None if getattr(out, f) is None else getattr(out, f).numpy() for f in FIELDS],
            [None if getattr(jout, f) is None else np.asarray(getattr(jout, f)) for f in FIELDS],
        )


def _small(small_scene, **overrides):
    jc, rir_a, rir_b = small_scene
    return dataclasses.replace(jc, **overrides), rir_a, rir_b


_F64_VARIANTS = {
    "default": {},
    "perceptual": dict(perceptual=True),
    "hop32": dict(hop_size=32),
    "matlab-toeplitz": dict(toeplitz_variant=ToeplitzVariant.MATLAB),
    "per-zone-spans": dict(
        target_filter=TargetFilterVariant.PER_ZONE, output_spans=(1, 3, 6)
    ),
    "run-b-off-normalized": dict(run_b=False, normalize_statistics=True),
    "matmul-dft": dict(use_matmul_dft=True, perceptual=True),
}


@pytest.mark.parametrize("variant", list(_F64_VARIANTS))
def test_float64_parity(small_scene, variant):
    pair = _Pair(*_small(small_scene, **_F64_VARIANTS[variant]))
    worst = 0.0
    for _ in range(6):
        got, want = pair.step(*pair.inputs())
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.shape == w.shape
                worst = max(worst, _rel(g, w))
    assert worst <= 1e-9, f"max relative error vs JAX: {worst:.3e}"


def _slice_config(jc, **extra):
    overrides = production_overrides("tpu") | dict(
        gevd_solver=GevdSolver.EIGH, perceptual=True
    )
    return dataclasses.replace(jc, **overrides, **extra)


def _s8_scene():
    rir_a = synthetic_rirs(96, 8, 3, seed=81)
    rir_b = synthetic_rirs(96, 8, 3, seed=82)
    jc = ApVastConfig.for_rirs(
        rir_a, rir_b, block_size=128, filter_length=12, modeling_delay=4,
        reference_index_a=0, reference_index_b=5, num_eigenvectors=8, mu=1.0,
        statistics_buffer_length=128, sampling_rate=8000, perceptual=True,
    )
    return jc, rir_a, rir_b


def _jax_statistics(jc, state):
    """(R, r) of a JAX post-hop state through the JAX skew path (the state
    carries the deleted-form buffer under these configs)."""
    assert jc.carried_deleted_statistics
    buf = state.wresp_stat
    k = buf.shape[-1] - jc.filter_length + 1
    return covariance_via_lags_skew(buf, state.wtarget_stat[..., -k:], jc.filter_length)


@pytest.mark.parametrize("scene", ["S4", "S8"])
def test_slice_config_float32(small_scene, scene):
    jc, rir_a, rir_b = small_scene if scene == "S4" else _s8_scene()
    jc = _slice_config(jc)
    pair = _Pair(jc, rir_a, rir_b)
    assert pair.tc.use_pallas_conv and pair.tc.use_lag_statistics
    assert pair.tc.lag_assembly == "skew" and pair.tc.use_pallas_output
    got_all, want_all = [], []
    for _ in range(5):
        got, want = pair.step(*pair.inputs())
        got_all.append(got)
        want_all.append(want)
        r_port = hop_statistics(pair.tc, pair.state.wresp_stat, pair.state.wtarget_stat)
        r_jax = _jax_statistics(jc, pair.jstate)
        for g, w in zip(r_port, r_jax):
            assert _rel(g.numpy(), w) <= 1e-4
    for f, name in enumerate(FIELDS):
        g = np.stack([x[f] for x in got_all])
        w = np.stack([x[f] for x in want_all])
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.isfinite(g).all()
        assert _rel(g, w) <= (1e-5 if name.endswith("_t") else 5e-2), name


@pytest.mark.parametrize("config", ["f64-default", "f32-slice"])
def test_state_carried_over_from_jax(small_scene, config):
    jc, rir_a, rir_b = small_scene
    if config == "f32-slice":
        jc = _slice_config(jc)
    pair = _Pair(jc, rir_a, rir_b, seed=11)
    for _ in range(3):
        a, b = pair.inputs()
        pair.jstate, _ = pair._jhop(pair.jstate, jnp.asarray(a), jnp.asarray(b))
    carried = {
        f.name: None if getattr(pair.jstate, f.name) is None
        else np.asarray(getattr(pair.jstate, f.name))
        for f in dataclasses.fields(pair.jstate)
    }
    pair.state = state_from_numpy(pair.tc, carried, device="cpu")
    got, want = pair.step(*pair.inputs())
    for name, g, w in zip(FIELDS, got, want):
        if jc.dtype == "float64":
            tol = 1e-9
        else:
            tol = 1e-5 if name.endswith("_t") else 5e-2
        assert _rel(g, w) <= tol, name


def test_skew_statistics_need_float32(small_scene):
    """Float64 skew lag statistics: K2 and K3 are float32 kernels, so C0
    comes by convolution and the layout from K3's plain version, as the JAX
    engine computes them in float64 on the CPU (its kernel in interpret
    mode); the hop equals the JAX engine's within 1e-9 (the port raised
    here before)."""
    pair = _Pair(*_small(small_scene, use_lag_statistics=True, lag_assembly="skew"))
    assert pair.tc.dtype == "float64"
    for _ in range(4):
        got, want = pair.step(*pair.inputs())
        for g, w in zip(got, want):
            assert g.dtype == np.float64 and _rel(g, w) <= 1e-9
