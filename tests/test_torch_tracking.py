"""The port's hop with the tracking GEVD solver against the JAX engine.

1. Float64 parity (``small_eigh="lapack"``, full-form statistics, a
   rebuild every 4 hops, no residual trigger) over 12 hops: <= 1e-9 of
   each output's scale, for both Rayleigh-Ritz bases; only rounding
   separates the two packages.
2. The float32 production configuration (``production_overrides("tpu")``,
   perceptual on: half-form skew statistics, the direct basis, K4 at 2
   sweeps) at S=4 and S=8. The statistics do not depend on the solver and
   are held to 1e-4 of their scale over a free-running stream, the target
   feeds to 1e-5. The loudspeaker feeds are held to 5e-2 of signal scale
   hop by hop from the JAX state carried across before every hop: 2 Jacobi
   sweeps do not converge, and a rotation pair with theta ~ 0 picks a
   +-45 degree angle from float32 rounding, so a free-running stream
   drifts; the JAX engine itself moves its feeds by up to 1.4e-1 of scale
   when its initial noise is perturbed by 1e-6 relative (measured on the
   S=4 scene), against 3e-2 at 4 sweeps or with LAPACK.
3. A JAX tracking state carried into the port mid-stream (float64, 1e-9).
4. Behaviour the JAX tests pin (``tests/test_tracking_solver.py``): the
   residual-triggered rebuild after a +20 dB level step, recovery after a
   true-silence gap, and contrast within 0.3 dB of the exact solver.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.engine import build_plan, hop_statistics, init_state, process_hop
from apvast_torch.engine.hop import half_form
from apvast_torch.evaluation import acoustic_contrast_db, predict_pressure
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_tpu.config import ApVastConfig, GevdSolver, production_overrides
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


def _arrays(state) -> dict:
    return {
        f.name: None if getattr(state, f.name) is None else np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


class _Pair:
    """One scene, noise, cold basis and hop inputs through both engines."""

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
        self.state = init_state(
            self.tc, device="cpu", response_noise=noise,
            subspace_init=np.array(self.jstate.gevd_q),
        )
        self._jhop = jax.jit(lambda st, a, b: jax_process_hop(jc, self.jplan, st, a, b))

    def inputs(self, scale=1.0):
        dt = np.dtype(self.jc.dtype)
        return tuple((scale * self.rng.standard_normal(self.jc.hop)).astype(dt) for _ in range(2))

    def step(self, a, b, carry_jax_state=False):
        """One hop of each engine; with ``carry_jax_state`` the port starts
        from the JAX state. Returns port and JAX outputs and whether each
        rebuilt its preconditioner."""
        if carry_jax_state:
            self.state = state_from_numpy(self.tc, _arrays(self.jstate), device="cpu")
        prev_minv = self.jstate.gevd_minv
        self.jstate, jout = self._jhop(self.jstate, jnp.asarray(a), jnp.asarray(b))
        self.state, out = process_hop(
            self.tc, self.plan, self.state, torch.from_numpy(a), torch.from_numpy(b)
        )
        assert int(out.silenced) == 0 and int(jout.silenced) == 0
        jax_rebuilt = not np.array_equal(np.asarray(prev_minv), np.asarray(self.jstate.gevd_minv))
        got = [getattr(out, f).numpy() for f in FIELDS]
        want = [np.asarray(getattr(jout, f)) for f in FIELDS]
        return got, want, out.rebuilt, jax_rebuilt


def _tracking(jc, **extra):
    return dataclasses.replace(
        jc, gevd_solver=GevdSolver.SUBSPACE, subspace_whiten="tracking", **extra
    )


@pytest.mark.parametrize("basis", ["cholqr2", "direct"])
def test_tracking_float64_parity(small_scene, basis):
    jc, rir_a, rir_b = small_scene
    jc = _tracking(jc, tracking_rebuild_period=4, tracking_residual_rebuild=0.0,
                   tracking_rr_basis=basis)
    pair = _Pair(jc, rir_a, rir_b)
    worst, rebuilds = 0.0, []
    for _ in range(12):
        got, want, rebuilt, jax_rebuilt = pair.step(*pair.inputs())
        assert rebuilt == jax_rebuilt
        rebuilds.append(rebuilt)
        worst = max(worst, *(_rel(g, w) for g, w in zip(got, want)))
    # Warmup hops 0-3, then the cadence at hops 4 and 8.
    assert rebuilds == [True] * 5 + [False] * 3 + [True] + [False] * 3
    assert worst <= 1e-9, f"max relative error vs JAX: {worst:.3e}"
    assert pair.state.gevd_hop == 12 == int(pair.jstate.gevd_hop)
    assert abs(float(pair.state.gevd_resid) - float(pair.jstate.gevd_resid)) <= 1e-6


def test_rebuild_override(small_scene):
    """A caller's ``rebuild_override`` replaces the cadence in both
    packages: the factor is refreshed on exactly the hops it names."""
    jc, rir_a, rir_b = small_scene
    jc = _tracking(jc)
    pair = _Pair(jc, rir_a, rir_b, seed=8)
    jhop = jax.jit(
        lambda st, a, b, r: jax_process_hop(jc, pair.jplan, st, a, b, rebuild_override=r)
    )
    for override in (True, False, False, True, False):
        a, b = pair.inputs()
        prev_minv = np.asarray(pair.jstate.gevd_minv)
        pair.jstate, jout = jhop(pair.jstate, jnp.asarray(a), jnp.asarray(b), jnp.asarray(override))
        prev_li = pair.state.gevd_minv
        pair.state, out = process_hop(
            pair.tc, pair.plan, pair.state, torch.from_numpy(a), torch.from_numpy(b),
            rebuild_override=override,
        )
        assert out.rebuilt is override
        assert (pair.state.gevd_minv is not prev_li) == override
        assert (not np.array_equal(prev_minv, np.asarray(pair.jstate.gevd_minv))) == override
        for f in FIELDS:
            assert _rel(getattr(out, f).numpy(), np.asarray(getattr(jout, f))) <= 1e-9


def _s8_scene():
    rir_a = synthetic_rirs(96, 8, 3, seed=81)
    rir_b = synthetic_rirs(96, 8, 3, seed=82)
    jc = ApVastConfig.for_rirs(
        rir_a, rir_b, block_size=128, filter_length=12, modeling_delay=4,
        reference_index_a=0, reference_index_b=5, num_eigenvectors=8, mu=1.0,
        statistics_buffer_length=128, sampling_rate=8000, perceptual=True,
    )
    return jc, rir_a, rir_b


@pytest.mark.parametrize("scene", ["S4", "S8"])
def test_production_config_float32(small_scene, scene):
    jc, rir_a, rir_b = small_scene if scene == "S4" else _s8_scene()
    jc = dataclasses.replace(jc, **production_overrides("tpu"), perceptual=True)
    free, forced = _Pair(jc, rir_a, rir_b), _Pair(jc, rir_a, rir_b)
    assert half_form(free.tc) and free.tc.small_eigh == "jacobi"
    for _ in range(10):
        hops = free.inputs()
        forced.inputs()  # the same draws keep both pairs on one signal
        got, want, _, _ = free.step(*hops)
        for name, g, w in zip(FIELDS, got, want):
            assert g.dtype == np.float32 and g.shape == w.shape and np.isfinite(g).all()
            if name.endswith("_t"):
                assert _rel(g, w) <= 1e-5, name
        k = jc.statistics_buffer_length - 1 - jc.filter_length + 1
        r_port = hop_statistics(free.tc, free.state.wresp_stat, free.state.wtarget_stat)
        r_jax = covariance_via_lags_skew(
            free.jstate.wresp_stat, free.jstate.wtarget_stat[..., -k:], jc.filter_length,
            form="half",
        )
        for g, w in zip(r_port, r_jax):
            assert _rel(g.numpy(), w) <= 1e-4
        got, want, rebuilt, jax_rebuilt = forced.step(*hops, carry_jax_state=True)
        assert rebuilt == jax_rebuilt
        for name, g, w in zip(FIELDS, got, want):
            assert _rel(g, w) <= (1e-5 if name.endswith("_t") else 5e-2), name


def test_jax_tracking_state_carried_over(small_scene):
    jc, rir_a, rir_b = small_scene
    jc = _tracking(jc, tracking_rebuild_period=3)
    pair = _Pair(jc, rir_a, rir_b, seed=11)
    for _ in range(5):
        a, b = pair.inputs()
        pair.jstate, _ = pair._jhop(pair.jstate, jnp.asarray(a), jnp.asarray(b))
    carried = state_from_numpy(pair.tc, _arrays(pair.jstate), device="cpu")
    assert carried.gevd_hop == 5 and carried.gevd_resid.dtype == torch.float32
    assert carried.gevd_q.shape == (2, jc.jl, jc.subspace_rank)
    pair.state = carried
    for _ in range(3):
        got, want, rebuilt, jax_rebuilt = pair.step(*pair.inputs())
        assert rebuilt == jax_rebuilt
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-9


def _mini(**extra):
    cfg = ApVastConfig(
        rir_length=64, num_srcs=4, num_mics=8, block_size=64, filter_length=8,
        modeling_delay=3, reference_index_a=0, reference_index_b=1, num_eigenvectors=4,
        mu=1.0, statistics_buffer_length=96, sampling_rate=8000, perceptual=False,
        dtype="float32", gevd_solver=GevdSolver.SUBSPACE, subspace_whiten="tracking",
        tracking_warmup_hops=2, **extra,
    )
    return cfg, synthetic_rirs(64, 4, 8, seed=1), synthetic_rirs(64, 4, 8, seed=2)


@pytest.mark.parametrize("threshold", [0.0, 0.35])
def test_residual_rebuild_after_level_step(threshold):
    """With the cadence off (period 10000), a +20 dB level step raises the
    carried Ritz residual past the threshold and forces a rebuild on the
    same hops as in JAX; with the trigger off nothing rebuilds after the
    warmup."""
    jc, rir_a, rir_b = _mini(tracking_rebuild_period=10_000,
                             tracking_residual_rebuild=threshold)
    pair = _Pair(jc, rir_a, rir_b, seed=5)
    late = []
    for h in range(16):
        got, want, rebuilt, jax_rebuilt = pair.step(*pair.inputs(0.1 if h < 8 else 1.0))
        assert rebuilt == jax_rebuilt
        if h >= 8:
            late.append(rebuilt)
    assert np.isfinite(float(pair.state.gevd_resid))
    assert any(late) == (threshold > 0)


def test_recovers_after_true_silence():
    """20 hops of exact silence collapse the pencil; the basis-health guard
    keeps the carried basis finite and non-degenerate, and the zone's
    contrast comes back once the signal returns (the broken solver reads
    -inf or 0 dB here)."""
    cfg, rir_a, rir_b = _mini(
        tracking_rebuild_period=32, tracking_rr_basis="direct",
        tracking_residual_rebuild=2.5, use_lag_statistics=True, lag_assembly="skew",
        statistics_half_form=True,
    )
    tc = config_from_jax(dataclasses.asdict(cfg))
    plan = build_plan(tc, rir_a, rir_b, device="cpu")
    state = init_state(tc, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    tail = []
    for h in range(60):
        if 16 <= h < 36:
            a = b = np.zeros(tc.hop, np.float32)
        else:
            a, b = (rng.standard_normal(tc.hop).astype(np.float32) for _ in range(2))
        state, out = process_hop(tc, plan, state, torch.from_numpy(a), torch.from_numpy(b))
        q = state.gevd_q
        assert bool(torch.isfinite(q).all()), h
        assert float((q * q).sum(-2).min()) > 1e-20, h
        if h >= 44:
            tail.append(out.out_a[0])
    feeds = torch.cat(tail).double()
    contrast = acoustic_contrast_db(predict_pressure(feeds, rir_a), predict_pressure(feeds, rir_b))
    assert torch.isfinite(feeds).all() and float(contrast) > 3.0


def _contrast(tc, rir_a, rir_b, noise, hops=10):
    plan = build_plan(tc, rir_a, rir_b, device="cpu")
    state = init_state(tc, device="cpu", response_noise=noise)
    rng = np.random.default_rng(4)
    outs = []
    for _ in range(hops):
        a, b = (torch.from_numpy(rng.standard_normal(tc.hop)) for _ in range(2))
        state, out = process_hop(tc, plan, state, a, b)
        assert int(out.silenced) == 0
        outs.append(out.out_a[0])
    feeds = torch.cat(outs[5:])  # rank 1
    return float(acoustic_contrast_db(predict_pressure(feeds, rir_a), predict_pressure(feeds, rir_b)))


def test_tracking_contrast_matches_exact(small_scene):
    jc, rir_a, rir_b = small_scene
    rng = np.random.default_rng(0)
    m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
    noise = (1e-3 * rng.standard_normal((4, m, s, block)), 1e-3 * rng.standard_normal((2, m, block)))
    exact = _contrast(config_from_jax(dataclasses.asdict(jc)), rir_a, rir_b, noise)
    tracked = _contrast(
        config_from_jax(dataclasses.asdict(_tracking(jc, tracking_warmup_hops=4))),
        rir_a, rir_b, noise,
    )
    assert abs(exact - tracked) < 0.3, f"contrast {exact:.2f} vs {tracked:.2f} dB"
