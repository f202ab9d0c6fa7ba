"""The port's public surface: ``ApVast`` hop by hop against whole signals,
the device rule, the configurations once refused (every one runs now), and
the evaluation metrics against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch import ApVast, GevdSolver, build_plan, production_overrides
from apvast_torch.config import RegularizationVariant, check_port_slice
from apvast_torch.engine import init_state, process_hop
from apvast_torch.evaluation import acoustic_contrast_db, normalized_mse, predict_pressure
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_torch.utils.rir import synthetic_rirs
from apvast_torch.utils.scenes import reference_scene, scale_scene
from apvast_tpu import evaluation as jax_evaluation
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

_SCENE = dict(
    block_size=128, filter_length=16, modeling_delay=5, reference_index_a=1,
    reference_index_b=2, number_of_eigenvectors=6, mu=1.0,
    statistics_buffer_length=160, sampling_rate=8000,
)


def _rirs():
    return synthetic_rirs(120, 4, 3, seed=1), synthetic_rirs(120, 4, 3, seed=2)


def _model(**overrides):
    rir_a, rir_b = _rirs()
    kwargs = dict(_SCENE, perceptual=False, device="cpu") | overrides
    return ApVast(rir_a=rir_a, rir_b=rir_b, **kwargs)


_EXACT = production_overrides() | {"gevd_solver": GevdSolver.EIGH}


@pytest.mark.parametrize("config", ["f64-default", "f32-slice", "f32-production"])
def test_hop_by_hop_equals_process_signals(config):
    overrides = {
        "f64-default": {},
        "f32-slice": dict(_EXACT, perceptual=True),
        "f32-production": dict(production_overrides(), perceptual=True),
    }[config]
    rng = np.random.default_rng(42)
    noise = (1e-3 * rng.standard_normal((4, 3, 4, 128)), 1e-3 * rng.standard_normal((2, 3, 128)))
    hop = 64
    sig_a, sig_b = rng.standard_normal(hop * 6 + 17), rng.standard_normal(hop * 6 + 17)
    whole = _model(response_noise=noise, **overrides)
    outs = whole.process_signals(sig_a, sig_b)  # the trailing 17 samples are dropped
    stepped = _model(response_noise=noise, **overrides)
    per_hop = [
        stepped.process_input_buffers(sig_a[i * hop : (i + 1) * hop], sig_b[i * hop : (i + 1) * hop])
        for i in range(6)
    ]
    for f in range(4):
        want = torch.cat([p[f] for p in per_hop], dim=1)  # (V, T, S)
        assert outs[f].shape == (6, 6 * hop, 4)
        torch.testing.assert_close(outs[f], want, rtol=0, atol=0)
    assert int(whole.silenced) == 0 and int(stepped.silenced) == 0
    assert whole.rebuilds == stepped.rebuilds == (6 if config == "f32-production" else 0)
    torch.testing.assert_close(whole.state.out_overlap, stepped.state.out_overlap, rtol=0, atol=0)


def test_disabled_zone_and_hop_length():
    m = _model(run_b=False)
    out_a, out_b, out_a_t, out_b_t = m.process_input_buffers(np.ones(64), np.ones(64))
    assert out_b is None and out_a.shape == (6, 64, 4) and out_b_t.shape == (6, 64, 4)
    with pytest.raises(ValueError, match="hop=64"):
        m.process_input_buffers(np.ones(63), np.ones(63))


def test_default_device_is_cuda():
    """Without device="cpu" every entry point runs on the card, and raises
    when there is none: no silent CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    rir_a, rir_b = _rirs()
    with pytest.raises(RuntimeError, match="CUDA"):
        ApVast(rir_a=rir_a, rir_b=rir_b, **_SCENE)
    cfg = _model().config
    with pytest.raises(RuntimeError, match="CUDA"):
        build_plan(cfg, rir_a, rir_b)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg)


_ROUND3 = dict(gevd_solver=GevdSolver.SUBSPACE, dtype="float32", subspace_oversample=10)


@pytest.mark.parametrize(
    "overrides",
    [
        production_overrides() | {"subspace_whiten": "newton"},
        dict(gevd_solver=GevdSolver.SUBSPACE),
        dict(weighting_conv_taps=31),
        dict(use_pallas_statistics=True, dtype="float32"),
        dict(use_lag_statistics=True, lag_assembly="wide"),
        dict(regularization=RegularizationVariant.MATLAB),
        dict(regularization=RegularizationVariant.PYTHON_NORM),
        production_overrides() | {"tracking_li_bf16": True},
        production_overrides() | {"tracking_residual_precision": "default"},
        _ROUND3 | dict(use_pallas_subspace=True),
        _ROUND3 | dict(use_pallas_whiten=True),
    ],
    ids=["production-newton", "subspace", "weighting-conv", "dense-pallas-statistics",
         "wide-assembly", "matlab-loading", "python-norm-loading", "bf16-preconditioner",
         "bf16-residual", "subspace-kernel", "whiten-kernel"],
)
def test_out_of_slice_configs_raise(overrides):
    """Every configuration once refused as out of the port's slices runs
    now: the round-3 subspace solvers ('invert' by default, 'newton') and
    their kernels, the truncated weighting, the dense statistics kernel,
    the wide lag assembly (the JAX package's default), the norm-scaled
    loadings (MATLAB, PYTHON_NORM) and the tracking solver's bfloat16
    knobs: each converts and runs a hop."""
    m = _model(**overrides)
    assert config_from_jax(dataclasses.asdict(m.config)) == m.config
    out = m.process_input_buffers(np.ones(64), np.ones(64))
    assert all(torch.isfinite(o).all() for o in out) and int(m.silenced) == 0


def test_out_of_slice_config_raises_in_the_hop(small_scene):
    """The wide lag assembly (refused by the hop before the port ran it)
    runs in the hop, and three hops equal the JAX package's in float64;
    only a dtype the port does not run is refused now."""
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, use_lag_statistics=True, lag_assembly="wide")
    tc = config_from_jax(dataclasses.asdict(jc))
    jplan, jstate = jax_build_plan(jc, rir_a, rir_b), jax_init_state(jc, key=jax.random.key(0))
    plan = build_plan(tc, rir_a, rir_b, "cpu")
    state = state_from_numpy(tc, {f.name: None if getattr(jstate, f.name) is None
                                  else np.asarray(getattr(jstate, f.name))
                                  for f in dataclasses.fields(jstate)}, "cpu")
    rng = np.random.default_rng(8)
    for _ in range(3):
        a, b = rng.standard_normal(tc.hop), rng.standard_normal(tc.hop)
        state, out = process_hop(tc, plan, state, torch.from_numpy(a), torch.from_numpy(b))
        jstate, jout = jax_process_hop(jc, jplan, jstate, jnp.asarray(a), jnp.asarray(b))
        want = np.asarray(jout.out_a)
        np.testing.assert_allclose(out.out_a.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())
    with pytest.raises(ValueError, match="dtype"):
        check_port_slice(dataclasses.replace(tc, dtype="bfloat16"))


def test_jacobi_refuses_float64():
    """small_eigh="jacobi" is a float32 kernel: a float64 hop raises, as in
    JAX (engine/hop.py)."""
    m = _model(gevd_solver=GevdSolver.SUBSPACE, subspace_whiten="tracking", small_eigh="jacobi")
    with pytest.raises(ValueError, match="float32 kernel"):
        m.process_input_buffers(np.ones(64), np.ones(64))


def test_production_hop_with_a_disabled_zone():
    """run_b=False under the production config: the half-form filler
    (0.5 I, so M + M^T = I) keeps zone B's pencil factorizable."""
    m = _model(run_b=False, perceptual=True, **production_overrides())
    for _ in range(3):
        out_a, out_b, _, _ = m.process_input_buffers(np.ones(64), np.ones(64))
    assert out_b is None and torch.isfinite(out_a).all() and int(m.silenced) == 0


def test_metrics_equal_jax():
    rng = np.random.default_rng(3)
    feeds = rng.standard_normal((2, 300, 4))
    rir_a, rir_b = _rirs()
    got = predict_pressure(torch.from_numpy(feeds), rir_a)
    want = np.asarray(jax_evaluation.predict_pressure(jnp.asarray(feeds), jnp.asarray(rir_a)))
    assert got.shape == want.shape == (2, 300, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-14)
    dark = predict_pressure(torch.from_numpy(feeds), rir_b)
    jdark = jax_evaluation.predict_pressure(jnp.asarray(feeds), jnp.asarray(rir_b))
    np.testing.assert_allclose(
        acoustic_contrast_db(got, dark).numpy(),
        np.asarray(jax_evaluation.acoustic_contrast_db(jnp.asarray(want), jdark)), rtol=1e-10,
    )
    np.testing.assert_allclose(
        normalized_mse(got, dark).numpy(),
        np.asarray(jax_evaluation.normalized_mse(jnp.asarray(want), jdark)), rtol=1e-10,
    )


def test_scenes_match_their_published_geometry():
    ns = scale_scene(16)
    c = ns.config
    assert (c.num_srcs, c.num_mics, c.filter_length, c.jl, c.rir_length) == (16, 17, 50, 800, 2400)
    assert (c.block_size, c.hop, c.statistics_buffer_length, c.num_eigenvectors) == (1600, 800, 1000, 50)
    assert c.perceptual and c.dtype == "float32"
    assert ns.rir_a.shape == (2400, 16, 17)
    ref = reference_scene()
    assert ref.rir_a.shape == (800, 8, 9) and ref.config.jl == 800
