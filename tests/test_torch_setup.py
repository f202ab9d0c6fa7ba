"""Setup-time parity of the PyTorch port with the JAX package: the config
(fields, derived properties, validation errors, production values), the
perceptual tables, every plan array and every initial state array.

Tolerances: the plan's FFT spectra and windows are computed by two FFT
and sine implementations, so they agree to a few units of the dtype's
rounding (1e-12 of the array's scale in float64, 2e-6 in float32); the
perceptual tables come from the same NumPy code and the state arrays are
copies and zeros, so those are exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apvast_torch.config as tcfg
from apvast_torch.engine import build_plan, init_state
from apvast_torch.perceptual import tables as ttables
from apvast_torch.utils.convert import (
    UNPORTED_FIELDS,
    config_from_jax,
    plan_from_numpy,
    state_from_numpy,
)
from apvast_tpu import config as jcfg
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.perceptual import tables as jtables

_DERIVED = (
    "hop", "carried_deleted_statistics", "effective_reg_b_relative", "num_bins",
    "jl", "num_solutions", "num_frames", "fir_fft_size", "fir_history",
)


def _slice(jax_config, **extra):
    """The JAX config under the port's slice: production values with the
    exact solver, perceptual weighting on."""
    overrides = jcfg.production_overrides("tpu") | dict(
        gevd_solver=jcfg.GevdSolver.EIGH, perceptual=True
    )
    return dataclasses.replace(jax_config, **overrides, **extra)


def _configs(small_scene):
    jc, rir_a, rir_b = small_scene
    return {
        "f64-default": (jc, rir_a, rir_b),
        "f64-perceptual": (dataclasses.replace(jc, perceptual=True), rir_a, rir_b),
        "f32-slice": (_slice(jc), rir_a, rir_b),
        "f32-slice-libdetectability": (
            _slice(jc, perceptual_frontend=jcfg.PerceptualFrontend.LIBDETECTABILITY),
            rir_a, rir_b,
        ),
    }


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(got.astype(want.dtype) - want).max() / scale)


@pytest.mark.parametrize(
    "name", ["f64-default", "f64-perceptual", "f32-slice", "f32-slice-libdetectability"]
)
def test_config_converts_field_for_field(small_scene, name):
    jc, _, _ = _configs(small_scene)[name]
    tc = config_from_jax(dataclasses.asdict(jc))
    ported = {f.name for f in dataclasses.fields(tc)}
    assert {f.name for f in dataclasses.fields(jc)} == ported | set(UNPORTED_FIELDS)
    for name in ported:
        jv, tv = getattr(jc, name), getattr(tc, name)
        assert getattr(tv, "value", tv) == getattr(jv, "value", jv), name
    for prop in _DERIVED:
        assert getattr(tc, prop) == getattr(jc, prop), prop


def test_production_overrides_equal_jax():
    want = jcfg.production_overrides("tpu")
    got = tcfg.production_overrides()
    assert set(got) | set(UNPORTED_FIELDS) >= set(want)
    for key, value in want.items():
        if key in got:
            assert getattr(got[key], "value", got[key]) == getattr(value, "value", value), key
        else:  # a solver knob: accepted at its production value
            assert value in UNPORTED_FIELDS[key][0], key
    assert tcfg.slice_overrides()["gevd_solver"] is tcfg.GevdSolver.EIGH


@pytest.mark.parametrize(
    "bad",
    [
        dict(block_size=127),
        dict(hop_size=0),
        dict(hop_size=200),
        dict(statistics_buffer_length=16),
        dict(modeling_delay=16),
        dict(reference_index_a=4),
        dict(reference_index_b=-1),
        dict(num_eigenvectors=65),
        dict(weighting_conv_taps=4),
        dict(lag_assembly="x"),
        dict(output_spans=()),
        dict(output_spans=(7,)),
    ],
    ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()),
)
def test_config_validation_errors_match_jax(small_scene, bad):
    jc, rir_a, rir_b = small_scene
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)} | bad
    with pytest.raises(ValueError) as jax_err:
        jcfg.ApVastConfig(**fields)
    t_fields = dataclasses.asdict(dataclasses.replace(jc)) | bad
    with pytest.raises(ValueError) as torch_err:
        config_from_jax(t_fields)
    assert str(torch_err.value) == str(jax_err.value)


_UNPORTED_JAX_INVALID = [
    dict(subspace_whiten="qr"),
    dict(tracking_rebuild_period=0),
    dict(tracking_li_bf16=True),
    dict(tracking_rr_basis="x"),
    dict(tracking_residual_precision="x"),
    dict(tracking_residual_precision="default"),
    dict(tracking_outer_steps=0),
    dict(tracking_residual_rebuild=-1.0),
    dict(fd_frame_taps=0),
    dict(fd_bin_coupling=2),
    dict(fd_span="x"),
    dict(fd_group_size=0),
    dict(fd_coupled_iters=-1),
    dict(fd_coupled_iters=1),
    dict(fd_coupled_iters=1, fd_span="full", fd_group_size=2, fd_bin_coupling=3),
    dict(fd_coupled_relax=0.0),
    dict(fd_coupled_method="x"),
    dict(fd_group_size=2),
    dict(fd_group_size=2, fd_span="full"),
]
_UNPORTED_JAX_VALID = [
    dict(subspace_oversample=20),
    dict(tracking_rebuild_period=8),
    dict(use_pallas_subspace=True),
    dict(fd_span="full"),
    dict(fd_eigh="jacobi"),
    dict(regularization=jcfg.RegularizationVariant.MATLAB, dark_loading=1e-2),
    dict(bright_loading=1e-6),
]


@pytest.mark.parametrize(
    "unported,jax_valid",
    [(d, False) for d in _UNPORTED_JAX_INVALID] + [(d, True) for d in _UNPORTED_JAX_VALID],
    ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()) if isinstance(d, dict) else None,
)
def test_unported_config_values_raise(small_scene, unported, jax_valid):
    """A JAX field that no ported path reads converts only at the values
    the slice runs with; any other value, valid in JAX or not, names the
    slice that brings it."""
    jc, _, _ = small_scene
    fields = dataclasses.asdict(dataclasses.replace(jc)) | unported
    if jax_valid:
        jcfg.ApVastConfig(**fields)
    else:
        with pytest.raises(ValueError):
            jcfg.ApVastConfig(**fields)
    with pytest.raises(NotImplementedError, match="slice"):
        config_from_jax(fields)


def test_rir_shape_errors_match_jax(small_scene):
    _, rir_a, _ = small_scene
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError, match="rirs of unequal size"):
            mod.ApVastConfig.for_rirs(rir_a, rir_a[:, :2])


@pytest.mark.parametrize(
    "args",
    [
        (1600, 48000.0, 94.0, "ISO226_2003"),
        (128, 8000.0, 94.0, "PAINTER_2000"),
        (256, 16000.0, 80.0, "NONE"),
    ],
)
def test_perceptual_tables_equal_jax(args):
    block, fs, spl, method = args
    got = ttables.build_perceptual_tables(block, fs, spl, tcfg.ThresholdMethod[method])
    want = jtables.build_perceptual_tables(block, fs, spl, jcfg.ThresholdMethod[method])
    lib_got = ttables.build_libdetectability_tables(block, fs, 32)
    lib_want = jtables.build_libdetectability_tables(block, fs, 32)
    for g, w in ((got, want), (lib_got, lib_want)):
        for f in dataclasses.fields(w):
            np.testing.assert_array_equal(getattr(g, f.name), getattr(w, f.name))


def _jax_plan_arrays(plan) -> dict:
    return {
        f.name: None if getattr(plan, f.name) is None else np.asarray(getattr(plan, f.name))
        for f in dataclasses.fields(plan)
    }


@pytest.mark.parametrize(
    "name", ["f64-default", "f64-perceptual", "f32-slice", "f32-slice-libdetectability"]
)
def test_plan_equals_jax(small_scene, name):
    jc, rir_a, rir_b = _configs(small_scene)[name]
    tc = config_from_jax(dataclasses.asdict(jc))
    want = _jax_plan_arrays(jax_build_plan(jc, rir_a, rir_b))
    got = build_plan(tc, rir_a, rir_b, device="cpu")
    tol = 1e-12 if tc.dtype == "float64" else 2e-6
    compared = 0
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        w = want[f.name]
        assert (g is None) == (w is None), f.name
        if g is None:
            continue
        assert tuple(g.shape) == w.shape, f.name
        assert g.dtype == torch.from_numpy(np.array(w)).dtype, f.name
        assert _rel(g.numpy(), w) <= tol, f.name
        compared += 1
    if jc.perceptual and jc.use_matmul_dft:
        assert compared == len(dataclasses.fields(got))  # every array built
    # The JAX plan's arrays carried across give the same plan.
    carried = plan_from_numpy(tc, want, device="cpu")
    for f in dataclasses.fields(carried):
        if want[f.name] is not None:
            np.testing.assert_array_equal(getattr(carried, f.name).numpy(), want[f.name])


@pytest.mark.parametrize("name", ["f64-default", "f32-slice"])
def test_init_state_equals_jax(small_scene, name):
    jc, _, _ = _configs(small_scene)[name]
    tc = config_from_jax(dataclasses.asdict(jc))
    rng = np.random.default_rng(5)
    m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
    noise = (rng.standard_normal((4, m, s, block)), rng.standard_normal((2, m, block)))
    want = jax_init_state(jc, response_noise=noise)
    got = init_state(tc, device="cpu", response_noise=noise)
    for f in dataclasses.fields(got):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)
    for f in ("gevd_q", "gevd_minv", "gevd_lam", "gevd_hop", "gevd_resid"):
        assert getattr(want, f) is None  # exact solver: no subspace carry
    carried = state_from_numpy(
        tc, {f.name: np.asarray(getattr(want, f.name)) for f in dataclasses.fields(got)},
        device="cpu",
    )
    np.testing.assert_array_equal(carried.resp.numpy(), np.asarray(want.resp))


def test_init_state_from_generator_and_zero(small_scene):
    jc, _, _ = small_scene
    tc = config_from_jax(dataclasses.asdict(jc))
    g1 = init_state(tc, "cpu", generator=torch.Generator().manual_seed(3))
    g2 = init_state(tc, "cpu", generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(g1.resp, g2.resp, rtol=0, atol=0)
    assert 0 < float(g1.resp.std()) < 1e-2
    zero = init_state(tc, "cpu")
    assert float(zero.resp.abs().max()) == 0.0
    with pytest.raises(ValueError, match="response_noise shapes"):
        init_state(tc, "cpu", response_noise=(np.zeros((4, 1, 1, 1)), np.zeros((2, 1, 1))))


def test_carried_arrays_are_shape_checked(small_scene):
    jc, rir_a, rir_b = small_scene
    tc = config_from_jax(dataclasses.asdict(jc))
    state = {f.name: np.asarray(getattr(jax_init_state(jc), f.name))
             for f in dataclasses.fields(init_state(tc, "cpu"))}
    state["resp"] = state["resp"][..., 1:]
    with pytest.raises(ValueError, match="resp"):
        state_from_numpy(tc, state, device="cpu")
    plan = _jax_plan_arrays(jax_build_plan(jc, rir_a, rir_b))
    plan["window"] = plan["window"][1:]
    with pytest.raises(ValueError, match="window"):
        plan_from_numpy(tc, plan, device="cpu")
    with pytest.raises(ValueError, match="fields the port's config does not have"):
        config_from_jax(dataclasses.asdict(jc) | {"bogus": 1})
    jnp.zeros(1)  # JAX stays usable beside the port in one process
