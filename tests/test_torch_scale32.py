"""The 32-speaker scene (BASELINE.json config 5, the JAX package's one-chip
scaling scene, ``scale_scene(32, **production_overrides("tpu"))``) through
the port's production path, against the JAX engine on the CPU.

The geometry is ``scale_scene(32)``'s: S = 32 loudspeakers, M = 33
microphones, 2400-tap RIRs, block 1600 / hop 800, statistics buffer 1000,
V = 50, subspace width k = 64, perceptual weighting on. Its depth is cut:
``filter_length`` 50 -> 4, so JL = 128 >= k = 64, and ``modeling_delay``
24 -> 2, which must lie below the filter length. The production test's
``slow`` parameters are deeper: JL = 800 (``filter_length`` 25,
``modeling_delay`` 12; ~25 s and ~2 GiB on one CPU) and the full depth, JL
= 1600.

The JAX engine runs its Pallas kernels in interpret mode on the CPU, as its
own tests do, except the streaming convolution: interpret mode unrolls its
2145 kernel rows into a program that takes about a minute to compile, so
the JAX side takes its plain reference there (``use_pallas_conv=False``,
the FFT overlap-save path), while the port keeps its production
configuration (K1's plain version on the CPU).

1. Production (float32): the port hop by hop from the JAX state carried
   across before every hop, through the six warmup rebuilds and past them:
   statistics within 1e-4 of scale, target feeds 1e-5 and loudspeaker feeds
   5e-2 of the scale of the stream's hops, the same rebuild decisions (the
   bars of ``tests/test_torch_tracking.py``). A hop whose loudspeaker feeds
   the JAX engine itself cannot hold to 5e-2 is held within SPREAD_FACTOR
   times the JAX hop's own spread: the largest move of its feeds, over
   SPREAD_SEEDS, when the statistics it is handed change by 1e-7 relative
   (about one float32 rounding), the rule the card tests hold their cold
   hop to (``tests/test_torch_cuda.py``). At JL = 128 no hop needs it. At
   JL = 800 the cold hops 2-3 do: there those changes move zone A's feeds
   of JAX itself by 0.14 and 0.15 (absolute, of a stream scale of 0.42),
   and the port reads 0.069 and 0.12 from JAX; from hop 4 on it reads at
   most 5.2e-3 (``tools/scale32_witness.py``).
2. Float64 tracking parity (``small_eigh="lapack"``, full-form statistics,
   the FFT DFT) over 8 free-running hops, both programs +20 dB from hop 7
   on: every output of every hop within 1e-9 of that hop's scale (the bar
   of ``tests/test_torch_tracking.py``), except on hops 2-3, within 1e-8.
   There zone B's feeds read 4.1e-9 and 3.3e-9 (5e-9 on another seed),
   and hops 1 and 4-8 at most 3.4e-10. The two packages' triangular
   inverses round differently, and hops 2-3 amplify that: taking either of
   the tracking solver's triangular inverses (the rebuild's Li, or the
   Rayleigh-Ritz whitening, on a Gram matrix of condition up to 4e14 there)
   by LAPACK's ``dtrtri`` instead moves the port alone by 1.5e-9 to 2.2e-9
   on those hops, while LAPACK's ``dsyevr`` for its eigensolve moves it by
   at most 2.1e-10 (``tools/scale32_witness.py``).
3. The same stream's tracking residual and rebuild decision on every hop
   equal the JAX engine's, on the JAX package's schedule (threshold 2.5,
   period 32, 6 warmup hops). At this depth the step cannot fire the
   residual trigger: the residual reads 0.36 on the hop before the step,
   0.71 on the step's hop and 0.94 on the next (JL = 128; the JAX
   package's 2.5 was set at JL = 1600, where its TPU read ~3.1 on the
   step). The threshold is not changed; the card runs the step at full
   width (``chip_smoke.py``, ``[phase 3 scale32]``).
4. The skew statistics in float64 (both forms) against JAX's at this
   scene's shapes: the port ran K2 and K3 on float64 input and raised.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch import production_overrides as port_production_overrides
from apvast_torch.engine import build_plan, hop_statistics, init_state, process_hop
from apvast_torch.ops.lag_statistics import covariance_via_lags_skew
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_tpu.config import production_overrides
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from apvast_tpu.ops.lag_statistics import covariance_via_lags_skew as jax_covariance_via_lags_skew
from apvast_tpu.utils.scenes import scale_scene
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")
CUT = {"filter_length": 4, "modeling_delay": 2}  # JL = 128; the full width is {}
# The JAX side's one plain-reference stage (see the module docstring).
JAX_CONV = {"use_pallas_conv": False}
FLOAT64 = {"dtype": "float64", "small_eigh": "lapack", "statistics_half_form": False,
           "use_pallas_output": False, "use_pallas_conv": False, "use_matmul_dft": False}
PARITY_HOPS = 8
STEP_HOP = 6  # 0-based: both programs +20 dB from here on
DEEP = {"filter_length": 25, "modeling_delay": 12}  # JL = 800
TOL_FEEDS = 5e-2  # of the stream's scale
SPREAD_FACTOR, SPREAD_SEEDS, SPREAD_REL = 4.0, (101, 102, 103), 1e-7
TOL_FLOAT64 = 1e-9  # of each hop's scale
TOL_FLOAT64_HOPS_2_3 = 1e-8  # the amplified hops (see the module docstring)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _arrays(state) -> dict:
    return {
        f.name: None if getattr(state, f.name) is None else np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


class _Scene32:
    """``scale_scene(32)`` at a depth, one seed's noise and cold basis, and
    the hop of each engine (JAX's jitted with the plan as an argument, so
    that its tables are not folded into the program as constants)."""

    def __init__(self, jax_overrides, port_overrides, cut, seed=3):
        scene = scale_scene(32, **cut, **jax_overrides)
        self.jc = jc = scene.config
        self.tc = dataclasses.replace(config_from_jax(dataclasses.asdict(jc)), **port_overrides)
        self.rng = np.random.default_rng(seed)
        m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
        noise = (1e-3 * self.rng.standard_normal((4, m, s, block)),
                 1e-3 * self.rng.standard_normal((2, m, block)))
        self.jplan = jax_build_plan(jc, scene.rir_a, scene.rir_b)
        self.jstate = jax_init_state(jc, response_noise=noise)
        self.plan = build_plan(self.tc, scene.rir_a, scene.rir_b, device="cpu")
        self.state = init_state(self.tc, device="cpu", response_noise=noise,
                                subspace_init=np.array(self.jstate.gevd_q))
        self._jhop = jax.jit(lambda plan, st, a, b: jax_process_hop(jc, plan, st, a, b))
        k = jc.statistics_buffer_length - jc.filter_length
        self.jax_statistics = jax.jit(lambda w, t: jax_covariance_via_lags_skew(
            w, t[..., -k:], jc.filter_length, form="half" if jc.statistics_half_form else "full"))

    def jax_spread(self, jstate, a, b):
        """The largest move of the JAX hop's loudspeaker feeds (out_a,
        out_b) from ``jstate`` when its statistics change by SPREAD_REL
        relative, over SPREAD_SEEDS."""
        base = self._jhop(self.jplan, jstate, jnp.asarray(a), jnp.asarray(b))[1]
        moves = []
        for seed in SPREAD_SEEDS:
            rng = np.random.default_rng(seed)
            changed = {}
            for name in ("wresp_stat", "wtarget_stat"):
                x = np.asarray(getattr(jstate, name))
                changed[name] = jnp.asarray(
                    x * (1 + SPREAD_REL * rng.standard_normal(x.shape)).astype(x.dtype))
            out = self._jhop(self.jplan, dataclasses.replace(jstate, **changed),
                             jnp.asarray(a), jnp.asarray(b))[1]
            moves.append([np.abs(np.asarray(getattr(out, f)) - np.asarray(getattr(base, f))).max()
                          for f in FIELDS[:2]])
        return np.max(moves, axis=0)

    def inputs(self, gain=1.0):
        dt = np.dtype(self.jc.dtype)
        return tuple((gain * self.rng.standard_normal(self.jc.hop)).astype(dt) for _ in range(2))

    def step(self, a, b, carry_jax_state=False):
        """One hop of each engine (the port from the JAX state with
        ``carry_jax_state``). Returns the port's and JAX's outputs and
        whether each rebuilt its preconditioner."""
        if carry_jax_state:
            self.state = state_from_numpy(self.tc, _arrays(self.jstate), device="cpu")
        prev_minv = np.asarray(self.jstate.gevd_minv)
        self.jstate, jout = self._jhop(self.jplan, self.jstate, jnp.asarray(a), jnp.asarray(b))
        self.state, out = process_hop(self.tc, self.plan, self.state, torch.from_numpy(a),
                                      torch.from_numpy(b))
        assert int(out.silenced) == 0 and int(jout.silenced) == 0
        jax_rebuilt = not np.array_equal(prev_minv, np.asarray(self.jstate.gevd_minv))
        got = [getattr(out, f).numpy() for f in FIELDS]
        want = [np.asarray(getattr(jout, f)) for f in FIELDS]
        return got, want, out.rebuilt, jax_rebuilt


@pytest.mark.parametrize("cut", [pytest.param(CUT, id="jl128"),
                                 pytest.param(DEEP, id="jl800", marks=pytest.mark.slow),
                                 pytest.param({}, id="jl1600", marks=pytest.mark.slow)])
def test_production_against_jax(cut):
    # The port's production WOLA is the FFT; JAX's TPU form, the DFT matmuls, on both sides.
    jax_wola = {"use_matmul_dft": production_overrides("tpu")["use_matmul_dft"]}
    pair = _Scene32(production_overrides("tpu") | JAX_CONV,
                    port_production_overrides() | jax_wola, cut)
    jc, tc = pair.jc, pair.tc
    assert (tc.num_srcs, tc.num_mics, tc.rir_length, tc.block_size, tc.hop) == (32, 33, 2400,
                                                                             1600, 800)
    assert tc.use_pallas_conv and tc.statistics_half_form and tc.small_eigh == "jacobi"
    assert tc.jl == 32 * jc.filter_length and jc.num_eigenvectors + 14 == 64
    decisions, feeds, carried = [], [], []
    for _ in range(tc.tracking_warmup_hops + 1):
        a, b = pair.inputs()
        carried.append((pair.jstate, a, b))
        got, want, rebuilt, jax_rebuilt = pair.step(a, b, carry_jax_state=True)
        decisions.append(rebuilt)
        assert rebuilt == jax_rebuilt
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape and np.isfinite(g).all()
        feeds.append((got, want))
        r_port = hop_statistics(tc, pair.state.wresp_stat, pair.state.wtarget_stat)
        r_jax = pair.jax_statistics(pair.jstate.wresp_stat, pair.jstate.wtarget_stat)
        for g, w in zip(r_port, r_jax):
            assert _rel(g.numpy(), w) <= 1e-4
    # The six warmup rebuilds, then the first tracked hop.
    assert decisions == [True] * tc.tracking_warmup_hops + [False]
    # Against the scale of the stream's hops (the cold first hop's feeds,
    # made from the initial noise alone, are ~1e-7 of it).
    for f, name in enumerate(FIELDS):
        got, want = (np.stack([hop[side][f] for hop in feeds]) for side in (0, 1))
        scale = np.abs(want).max()
        if name.endswith("_t"):
            assert _rel(got, want) <= 1e-5, name
            continue
        for h, (g, w) in enumerate(zip(got, want)):
            err = np.abs(g - w).max()
            if err > TOL_FEEDS * scale:  # beyond the bar: JAX's own spread (docstring)
                spread = pair.jax_spread(*carried[h])[f]
                assert err <= SPREAD_FACTOR * spread, (name, h + 1, err / scale, spread / scale)


@pytest.fixture(scope="module")
def float64_stream():
    """PARITY_HOPS free-running float64 hops of both engines, both programs
    +20 dB from STEP_HOP on: per hop the outputs, the residual after the
    hop and the rebuild decision of each engine."""
    pair = _Scene32(production_overrides("tpu") | FLOAT64, {}, CUT)
    hops = []
    for h in range(PARITY_HOPS):
        got, want, rebuilt, jax_rebuilt = pair.step(*pair.inputs(10.0 if h >= STEP_HOP else 1.0))
        hops.append(dict(got=got, want=want, rebuilt=rebuilt, jax_rebuilt=jax_rebuilt,
                         resid=float(pair.state.gevd_resid),
                         jax_resid=float(pair.jstate.gevd_resid)))
    return pair, hops


def test_float64_tracking_parity(float64_stream):
    pair, hops = float64_stream
    assert pair.tc.dtype == "float64" and not pair.tc.statistics_half_form
    for i, h in enumerate(hops):
        tol = TOL_FLOAT64_HOPS_2_3 if i + 1 in (2, 3) else TOL_FLOAT64
        for name, got, want in zip(FIELDS, h["got"], h["want"]):
            assert got.dtype == np.float64
            assert _rel(got, want) <= tol, (i + 1, name)


def test_residual_and_rebuilds_match_jax_through_a_step(float64_stream):
    pair, hops = float64_stream
    cfg = pair.tc
    assert (cfg.tracking_residual_rebuild, cfg.tracking_rebuild_period,
            cfg.tracking_warmup_hops) == (2.5, 32, 6)
    for h in hops:
        assert h["rebuilt"] == h["jax_rebuilt"]
        # The residual is carried in float32 by both engines.
        assert abs(h["resid"] - h["jax_resid"]) <= 1e-6 * max(1.0, abs(h["jax_resid"]))
    # The six warmup rebuilds; at this depth no hop reaches the threshold.
    assert [h["rebuilt"] for h in hops] == [True] * 6 + [False] * 2
    assert max(h["resid"] for h in hops) < cfg.tracking_residual_rebuild


@pytest.mark.parametrize("form", ["full", "half"])
def test_skew_statistics_float64(form):
    jc = scale_scene(32, **CUT).config
    j, n = jc.filter_length, jc.statistics_buffer_length - 1
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((4, jc.num_mics, jc.num_srcs, n))
    d = rng.standard_normal((2, jc.num_mics, n - j + 1))
    got = covariance_via_lags_skew(torch.from_numpy(buf), torch.from_numpy(d), j, form=form)
    want = jax_covariance_via_lags_skew(jnp.asarray(buf), jnp.asarray(d), j, form=form)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _rel(g.numpy(), w) <= 1e-12
