"""The port's norm-scaled loadings and the tracking solver's bfloat16 knobs
against the JAX engine, on the CPU.

1. PYTHON_NORM and MATLAB regularization (``_spectral_norm`` of the zones'
   matrices loading B, and under MATLAB also A) in float64 over 4 hops:
   <= 1e-9 of each output's scale, including the full MATLAB configuration
   of ``tests/test_matlab_variants.py`` and non-default loadings. Only
   rounding separates the two packages.
2. ``_spectral_norm`` against JAX's (1e-9) and against the exact 2-norm:
   1% on a clustered top spectrum and on a float32 matrix of norm 5e10;
   2.3% off on the lowpass-noise covariance's eigenvalue plateau in both
   packages, held to the JAX test's own 5% there.
3. ``tracking_li_bf16``: the carried factor in bfloat16, hop by hop from
   the JAX state carried across (float32 tolerances: loudspeaker feeds
   5e-2 of signal scale, target feeds 1e-5), and the JAX package's own
   contrast gate (0.05 dB of the float32 carry) on its own scene.
4. ``tracking_residual_precision="default"``: the single-pass product's
   operands are numpy's bfloat16 round-to-nearest-even bit for bit, its
   products exact and summed in float32. JAX on the CPU computes
   ``Precision.DEFAULT`` in full float32, so the JAX engine is run with
   its DEFAULT products given bfloat16-rounded operands
   (:func:`jax_single_pass`, which changes nothing in the JAX package),
   and the knob's hop is held to it hop by hop from the JAX state: the
   same silenced count every hop, the healthy hops' feeds to the float32
   tolerances above.
"""

import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.engine import build_plan, init_state, process_hop, run_stream
from apvast_torch.engine.hop import _spectral_norm
from apvast_torch.evaluation import acoustic_contrast_db, predict_pressure
from apvast_torch.ops.jdiag import bf16_round, single_pass_matmul
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_tpu.config import (
    ApVastConfig,
    GevdSolver,
    RegularizationVariant,
    TargetFilterVariant,
    ToeplitzVariant,
    WeightingNorm,
    production_overrides,
)
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from apvast_tpu.engine.hop import _spectral_norm as jax_spectral_norm
from apvast_tpu.utils.rir import synthetic_rirs
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")
MATLAB = dict(
    toeplitz_variant=ToeplitzVariant.MATLAB,
    normalize_statistics=True,
    regularization=RegularizationVariant.MATLAB,
    weighting_norm=WeightingNorm.UNIT_SYMMETRIC,
    target_filter=TargetFilterVariant.PER_ZONE,
    perceptual=True,
)


class _Proxy:
    """``base`` with some attributes replaced."""

    def __init__(self, base, **replaced):
        self._base, self._replaced = base, replaced

    def __getattr__(self, name):
        return self._replaced[name] if name in self._replaced else getattr(self._base, name)


def _single_pass(product):
    def call(a, b, *args, precision=None, **kwargs):
        if precision == jax.lax.Precision.DEFAULT:
            a, b = (x.astype(jnp.bfloat16).astype(jnp.float32) for x in (a, b))
            precision = jax.lax.Precision.HIGHEST
        return product(a, b, *args, precision=precision, **kwargs)

    return call


@contextlib.contextmanager
def jax_single_pass():
    """The JAX engine's ``Precision.DEFAULT`` products as the TPU's single
    pass computes them: both operands rounded to bfloat16 (to nearest, ties
    to even), their exact products summed in float32. JAX on the CPU
    computes DEFAULT in full float32. For the duration, the names ``jnp``
    and ``jax`` of ``apvast_tpu.ops.jdiag`` (whose tracking solver makes the
    package's only DEFAULT products) are proxies whose ``matmul`` and
    ``lax.dot_general`` round first; jit traces made inside see them. The
    package's files are not changed."""
    mod = importlib.import_module("apvast_tpu.ops.jdiag")  # ops.jdiag is also a function
    saved = mod.jnp, mod.jax
    mod.jnp = _Proxy(jnp, matmul=_single_pass(jnp.matmul))
    mod.jax = _Proxy(jax, lax=_Proxy(jax.lax, dot_general=_single_pass(jax.lax.dot_general)))
    try:
        yield
    finally:
        mod.jnp, mod.jax = saved


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _run_errors(runs) -> tuple[float, float]:
    """The largest error of the loudspeaker feeds and of the target feeds
    over a run of hops (``(got, want)`` pairs of :meth:`_Pair.step`), each
    relative to the run's scale of that field."""
    errs = [_rel(np.stack([g[f] for g, _ in runs]), np.stack([w[f] for _, w in runs]))
            for f in range(4)]
    return max(errs[:2]), max(errs[2:])


def _arrays(state) -> dict:
    return {f.name: None if getattr(state, f.name) is None else np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


class _Pair:
    """One scene, noise, cold basis and hop inputs through both engines."""

    def __init__(self, jc, rir_a, rir_b, seed=3):
        self.jc = jc
        self.tc = config_from_jax(dataclasses.asdict(jc))
        self.rng = np.random.default_rng(seed)
        m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
        noise = (1e-3 * self.rng.standard_normal((4, m, s, block)),
                 1e-3 * self.rng.standard_normal((2, m, block)))
        self.jplan = jax_build_plan(jc, rir_a, rir_b)
        self.jstate = jax_init_state(jc, response_noise=noise)
        self.plan = build_plan(self.tc, rir_a, rir_b, device="cpu")
        q = None if self.jstate.gevd_q is None else np.array(self.jstate.gevd_q)
        self.state = init_state(self.tc, device="cpu", response_noise=noise, subspace_init=q)
        self._jhop = jax.jit(lambda st, a, b: jax_process_hop(jc, self.jplan, st, a, b))
        self.dtype = np.dtype(jc.dtype)

    def inputs(self):
        return tuple(self.rng.standard_normal(self.jc.hop).astype(self.dtype) for _ in range(2))

    def step(self, a, b, healthy=True):
        """One hop in both engines: the feeds of each (``got``, ``want``).
        ``healthy``: both silenced nothing; else their counts are kept in
        ``self.silenced`` as (port, JAX)."""
        self.jstate, jout = self._jhop(self.jstate, jnp.asarray(a), jnp.asarray(b))
        self.state, out = process_hop(self.tc, self.plan, self.state, torch.from_numpy(a),
                                      torch.from_numpy(b))
        self.silenced = int(out.silenced), int(jout.silenced)
        assert not healthy or self.silenced == (0, 0), self.silenced
        return ([None if getattr(out, f) is None else getattr(out, f).numpy() for f in FIELDS],
                [None if getattr(jout, f) is None else np.asarray(getattr(jout, f))
                 for f in FIELDS])


_LOADINGS = {
    "python-norm": dict(regularization=RegularizationVariant.PYTHON_NORM),
    "matlab-loading": dict(regularization=RegularizationVariant.MATLAB),
    "matlab-config": MATLAB,
    "matlab-nondefault-loadings": MATLAB | dict(bright_loading=3e-4, dark_loading=2e-2),
    "python-norm-invert": dict(regularization=RegularizationVariant.PYTHON_NORM,
                               gevd_solver=GevdSolver.SUBSPACE),
}


@pytest.mark.parametrize("variant", list(_LOADINGS))
def test_norm_scaled_loadings_match_jax(small_scene, variant):
    jc, rir_a, rir_b = small_scene
    pair = _Pair(dataclasses.replace(jc, **_LOADINGS[variant]), rir_a, rir_b)
    assert pair.tc.regularization.value == pair.jc.regularization.value
    assert (pair.tc.bright_loading, pair.tc.dark_loading) == (pair.jc.bright_loading,
                                                              pair.jc.dark_loading)
    worst = 0.0
    for _ in range(4):
        got, want = pair.step(*pair.inputs())
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.shape == w.shape
                worst = max(worst, _rel(g, w))
    assert worst <= 1e-9, f"max relative error vs JAX: {worst:.3e}"


def test_production_matlab_hop_by_hop(small_scene):
    """The card's MATLAB path on the CPU: production values in full form
    (the tracking solver, K4 at 2 sweeps, full-form K3) with the MATLAB
    configuration, float32, hop by hop from the JAX state carried across
    (2 unconverged sweeps part free-running streams by rounding): target
    feeds to 1e-5 and loudspeaker feeds to 5e-2 of signal scale over 8
    hops, nothing silenced."""
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, **(production_overrides("tpu") | MATLAB
                                    | dict(statistics_half_form=False)))
    pair = _Pair(jc, rir_a, rir_b)
    runs = []
    for _ in range(8):
        pair.state = state_from_numpy(pair.tc, _arrays(pair.jstate), "cpu")
        runs.append(pair.step(*pair.inputs()))
    feeds, targets = _run_errors(runs)
    assert feeds <= 5e-2, feeds
    assert targets <= 1e-5, targets


def test_spectral_norm_matches_jax_and_exact():
    """The matrices of the JAX package's own test
    (tests/test_subspace_solver.py::test_spectral_norm_matches_exact)."""
    rng = np.random.default_rng(77)
    sig = np.convolve(rng.standard_normal(4000), np.ones(8) / 8)[:4000]
    frames = np.lib.stride_tricks.sliding_window_view(sig, 80)[::3]
    plateau = frames.T @ frames
    q, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    lam = np.concatenate([[1.001, 1.0], rng.uniform(0.01, 0.9, 62)])
    clustered = (q * lam) @ q.T
    clustered = (clustered + clustered.T) / 2
    big = (5e10 * (q * lam) @ q.T).astype(np.float32)
    big = (big + big.T) / 2
    for mat, bar_exact, bar_jax in ((plateau, 5e-2, 1e-9), (clustered, 1e-2, 1e-9),
                                    (big, 1e-2, 1e-6)):
        got = float(_spectral_norm(torch.from_numpy(mat)))
        want_jax = float(jax_spectral_norm(jnp.asarray(mat)))
        exact = float(np.linalg.norm(mat.astype(np.float64), 2))
        assert np.isfinite(got) and got > 0
        assert abs(got - want_jax) / want_jax <= bar_jax, (got, want_jax)
        assert abs(got - exact) / exact < bar_exact, (got, exact)
    # Batched over a leading axis, as the hop calls it: each matrix's own.
    both = torch.from_numpy(np.stack([clustered, 3.0 * clustered]))
    norms = _spectral_norm(both)
    single = float(_spectral_norm(torch.from_numpy(clustered)))
    torch.testing.assert_close(norms, torch.tensor([single, 3.0 * single], dtype=torch.float64),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("loading", [RegularizationVariant.PYTHON_NORM,
                                     RegularizationVariant.MATLAB])
def test_half_form_refuses_norm_scaled_loading(small_scene, loading):
    """The half form has no completed matrix to take a norm of: both
    packages raise the same ValueError from the hop."""
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, **production_overrides("tpu"), regularization=loading)
    hop = np.zeros(jc.hop, np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_process_hop(jc, jax_build_plan(jc, rir_a, rir_b), jax_init_state(jc),
                        jnp.asarray(hop), jnp.asarray(hop))
    tc = config_from_jax(dataclasses.asdict(jc))
    with pytest.raises(ValueError) as torch_err:
        process_hop(tc, build_plan(tc, rir_a, rir_b, "cpu"), init_state(tc, "cpu"),
                    torch.from_numpy(hop), torch.from_numpy(hop))
    assert str(torch_err.value) == str(jax_err.value)


def _bf16_config(**extra):
    """The JAX package's own tracking_li_bf16 scene
    (tests/test_tracking_solver.py::test_tracking_li_bf16_quality_and_validation)."""
    return ApVastConfig(
        rir_length=64, num_srcs=4, num_mics=8, block_size=64, filter_length=8,
        modeling_delay=3, reference_index_a=0, reference_index_b=1, num_eigenvectors=4,
        mu=1.0, statistics_buffer_length=96, sampling_rate=8000, perceptual=False,
        dtype="float32", gevd_solver=GevdSolver.SUBSPACE, subspace_whiten="tracking",
        tracking_warmup_hops=2, tracking_rebuild_period=3, **extra,
    )


def _bf16_rirs():
    return synthetic_rirs(64, 4, 8, seed=1), synthetic_rirs(64, 4, 8, seed=2)


def test_tracking_li_bf16_matches_jax():
    """Hop by hop from the JAX state (its bfloat16 carry read by
    ``state_from_numpy``), 10 hops over three rebuilds."""
    jc = _bf16_config(tracking_li_bf16=True)
    rir_a, rir_b = _bf16_rirs()
    pair = _Pair(jc, rir_a, rir_b)
    assert pair.jstate.gevd_minv.dtype == jnp.bfloat16
    assert pair.state.gevd_minv.dtype == torch.bfloat16
    runs = []
    for _ in range(10):
        pair.state = state_from_numpy(pair.tc, _arrays(pair.jstate), "cpu")
        assert pair.state.gevd_minv.dtype == torch.bfloat16
        torch.testing.assert_close(
            pair.state.gevd_minv.float(),
            torch.from_numpy(np.asarray(pair.jstate.gevd_minv, np.float32)), rtol=0, atol=0)
        runs.append(pair.step(*pair.inputs()))
        assert pair.state.gevd_minv.dtype == torch.bfloat16
        # The carried factor after the hop: the same bfloat16 values (a
        # rebuild rounds the same float32 factor up to its last bit).
        diff = (pair.state.gevd_minv.float().numpy()
                - np.asarray(pair.jstate.gevd_minv, np.float32))
        assert np.abs(diff).max() <= 1e-2 * np.abs(np.asarray(pair.jstate.gevd_minv,
                                                              np.float32)).max()
    feeds, targets = _run_errors(runs)
    assert feeds <= 5e-2, feeds
    assert targets <= 1e-5, targets


def test_tracking_li_bf16_contrast_and_validation():
    """The JAX package's gate: the bfloat16 carry keeps the engine finite
    and its contrast within 0.05 dB of the float32 carry's; a float64
    configuration refuses it with JAX's message."""
    rir_a, rir_b = _bf16_rirs()
    rng = np.random.default_rng(5)
    nh = 16
    sa = torch.from_numpy(rng.standard_normal(32 * nh).astype(np.float32))
    sb = torch.from_numpy(rng.standard_normal(32 * nh).astype(np.float32))
    contrasts = {}
    for bf in (False, True):
        tc = config_from_jax(dataclasses.asdict(_bf16_config(tracking_li_bf16=bf)))
        plan = build_plan(tc, rir_a, rir_b, "cpu")
        state = init_state(tc, "cpu", generator=torch.Generator().manual_seed(0))
        assert state.gevd_minv.dtype == (torch.bfloat16 if bf else torch.float32)
        final, outs = run_stream(tc, plan, state, sa, sb)
        assert final.gevd_minv.dtype == state.gevd_minv.dtype
        assert torch.isfinite(outs.out_a).all() and int(outs.silenced.sum()) == 0
        f = outs.out_a[nh // 2 :, 0].reshape(-1, 4).double()
        contrasts[bf] = float(acoustic_contrast_db(predict_pressure(f, rir_a),
                                                   predict_pressure(f, rir_b)))
    assert abs(contrasts[True] - contrasts[False]) < 0.05, contrasts
    fields = dataclasses.asdict(_bf16_config()) | dict(dtype="float64", tracking_li_bf16=True)
    with pytest.raises(ValueError, match="float32-production") as torch_err:
        config_from_jax(fields)
    with pytest.raises(ValueError) as jax_err:
        ApVastConfig(**fields)
    assert str(torch_err.value) == str(jax_err.value)


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """numpy emulation: float32 rounded to bfloat16, to nearest, ties to
    even, widened back to float32 (finite inputs)."""
    bits = x.astype(np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return ((bits + bias) & np.uint32(0xFFFF0000)).view(np.float32)


def test_single_pass_matmul_rounds_as_bf16():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 40, 40)).astype(np.float32)
    b = rng.standard_normal((3, 40, 9)).astype(np.float32)
    # Ties: a value halfway between two bfloat16 numbers goes to the even one.
    ties = np.array([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(1.0 + 2.0**-8)], np.float32)
    for x in (a, b, ties):
        got = bf16_round(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), _bf16_rne(x).view(np.uint32))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = single_pass_matmul(ta, tb)
    assert got.dtype == torch.float32
    want = torch.from_numpy(_bf16_rne(a)) @ torch.from_numpy(_bf16_rne(b))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))
    # The products are exact: against float64 sums of the rounded operands
    # the only error is float32 accumulation over 40 terms.
    exact = _bf16_rne(a).astype(np.float64) @ _bf16_rne(b).astype(np.float64)
    bound = 40 * np.finfo(np.float32).eps * (np.abs(_bf16_rne(a)).astype(np.float64)
                                             @ np.abs(_bf16_rne(b)).astype(np.float64))
    assert (np.abs(got.numpy() - exact) <= bound).all()
    # The output stays float32: not rounded back to bfloat16.
    assert not torch.equal(got, bf16_round(got))
    # A float64 input gets the same treatment (the knob is float32-only).
    assert single_pass_matmul(ta.double(), tb.double()).dtype == torch.float32


def test_residual_precision_default_runs(small_scene):
    """16 production hops with the single-pass residual path: finite, and
    its contrast beside the full-precision path's (printed, not gated; the
    knob costs ~6 dB at 32 speakers on the TPU). The cold first hop, whose
    Rayleigh-Ritz pencil on a random basis is ill-conditioned, silences
    under bfloat16 operands; the JAX engine does the same when its
    ``Precision.DEFAULT`` products are given bfloat16 operands as on the
    TPU (JAX on the CPU computes them in full float32). Every later hop is
    healthy."""
    jc, rir_a, rir_b = small_scene
    rng = np.random.default_rng(8)
    sa = torch.from_numpy(rng.standard_normal(jc.hop * 16).astype(np.float32))
    sb = torch.from_numpy(rng.standard_normal(jc.hop * 16).astype(np.float32))
    contrast = {}
    for precision in ("high", "default"):
        fields = dataclasses.asdict(jc) | production_overrides("tpu") | dict(
            perceptual=True, tracking_residual_precision=precision)
        tc = config_from_jax(fields)
        assert tc.tracking_residual_precision == precision
        _, outs = run_stream(tc, build_plan(tc, rir_a, rir_b, "cpu"),
                             init_state(tc, "cpu", generator=torch.Generator().manual_seed(1)),
                             sa, sb)
        assert torch.isfinite(outs.out_a).all() and int(outs.silenced[1:].sum()) == 0
        if precision == "high":
            assert int(outs.silenced[0]) == 0
        f = outs.out_a[6:, 0].reshape(-1, jc.num_srcs).double()
        contrast[precision] = float(acoustic_contrast_db(predict_pressure(f, rir_a),
                                                         predict_pressure(f, rir_b)))
        assert np.isfinite(contrast[precision])
        print(f"residual_precision={precision!r}: cold hop silenced {int(outs.silenced[0])}, "
              f"zone-A rank-1 contrast over hops 7-16 {contrast[precision]:.3f} dB")


def test_residual_precision_default_matches_jax_single_pass(small_scene):
    """The knob's hop against the JAX engine's with its DEFAULT products
    given bfloat16 operands (:func:`jax_single_pass`), production values,
    float32, hop by hop from the JAX state over 12 hops (the cold hop, the
    warmup rebuilds, tracking): the same silenced count on every hop, and
    loudspeaker feeds to 5e-2 and target feeds to 1e-5 of signal scale.
    Without the rounding the JAX engine silences no hop of these: the
    rounding is what silences the cold one."""
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, **(production_overrides("tpu") | dict(
        perceptual=True, tracking_residual_precision="default")))
    plain = _Pair(jc, rir_a, rir_b)  # the same noise, basis and inputs (seeded)
    plain_silenced = []
    for _ in range(12):
        plain.step(*plain.inputs(), healthy=False)
        plain_silenced.append(plain.silenced[1])
    with jax_single_pass():  # traced inside: the hop's DEFAULT products round
        pair = _Pair(jc, rir_a, rir_b)
        runs, silenced = [], []
        for _ in range(12):
            pair.state = state_from_numpy(pair.tc, _arrays(pair.jstate), "cpu")
            runs.append(pair.step(*pair.inputs(), healthy=False))
            silenced.append(pair.silenced)
    print(f"silenced per hop (port, JAX single pass): {silenced}; JAX in full float32: "
          f"{plain_silenced}")
    assert all(p == j for p, j in silenced), silenced
    assert silenced[0][0] > 0 and plain_silenced[0] == 0
    feeds, targets = _run_errors(runs)
    assert feeds <= 5e-2, feeds
    assert targets <= 1e-5, targets
