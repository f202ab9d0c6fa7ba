"""The port's observability and evaluation additions against the JAX
package's, on the CPU: ``hop_metrics`` (a disabled zone included) and
``run_stream_with_metrics`` in float64 within 1e-9 of scale (only
rounding separates the two packages), both ``detectability`` functions,
``HopTimer``, ``trace`` and ``checked_hop``'s verdict (an error or none)
against checkify's on a clean hop and on a hop with one ``inf`` input
sample."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch import production_overrides
from apvast_torch.engine import build_plan, init_state, process_hop, run_stream
from apvast_torch.engine.stream import run_stream_with_metrics
from apvast_torch.evaluation import detectability
from apvast_torch.observability import HopMetrics, HopTimer, checked_hop, hop_metrics, trace
from apvast_torch.perceptual.model import detectability as model_detectability
from apvast_torch.perceptual.model import squared_weighting
from apvast_torch.perceptual.tables import build_perceptual_tables
from apvast_torch.utils.convert import config_from_jax
from apvast_tpu import observability as jobs
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine.hop import HopOutputs as JaxHopOutputs
from apvast_tpu.engine.stream import run_stream_with_metrics as jax_run_stream_with_metrics
from apvast_tpu.evaluation import detectability as jax_detectability
from apvast_tpu.perceptual.model import detectability as jax_model_detectability
from apvast_tpu.perceptual.model import squared_weighting as jax_squared_weighting
from apvast_tpu.perceptual.tables import build_perceptual_tables as jax_build_perceptual_tables
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-9
METRICS = [f.name for f in dataclasses.fields(HopMetrics)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - want[fin]).max() / max(np.abs(want[fin]).max(), 1e-300))


def _noise(jc, rng):
    m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
    return (1e-3 * rng.standard_normal((4, m, s, block)),
            1e-3 * rng.standard_normal((2, m, block)))


def _port(jc, rir_a, rir_b, noise):
    tc = config_from_jax(dataclasses.asdict(jc))
    return tc, build_plan(tc, rir_a, rir_b, "cpu"), init_state(tc, "cpu", response_noise=noise)


@pytest.mark.parametrize("run_b", [True, False], ids=["both-zones", "zone-b-off"])
def test_hop_metrics_match_jax(small_scene, run_b):
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, perceptual=True, run_b=run_b)
    rng = np.random.default_rng(1)
    tc, plan, state = _port(jc, rir_a, rir_b, _noise(jc, rng))
    for _ in range(3):
        state, out = process_hop(tc, plan, state, *(torch.from_numpy(rng.standard_normal(tc.hop))
                                                    for _ in range(2)))
    got = hop_metrics(out, rir_a, rir_b)
    jout = JaxHopOutputs(
        out_a=jnp.asarray(out.out_a.numpy()),
        out_b=None if out.out_b is None else jnp.asarray(out.out_b.numpy()),
        out_a_t=jnp.asarray(out.out_a_t.numpy()), out_b_t=jnp.asarray(out.out_b_t.numpy()),
        silenced=jnp.asarray(out.silenced.numpy()),
    )
    want = jobs.hop_metrics(jout, jnp.asarray(rir_a), jnp.asarray(rir_b))
    for name in METRICS:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == (torch.int32 if name == "silenced" else torch.float64), name
        assert _rel(g, w) <= TOL, name
    assert got.output_rms.shape == (2, tc.num_solutions)
    if not run_b:
        assert torch.isnan(got.contrast_b_db).all() and (got.output_rms[1] == 0).all()
        assert torch.isfinite(got.contrast_a_db).all()


def test_run_stream_with_metrics_matches_jax(small_scene):
    """8 hops, float64, perceptual weighting on: every output and every
    metrics field; the outputs are ``run_stream``'s."""
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, perceptual=True)
    rng = np.random.default_rng(2)
    noise = _noise(jc, rng)
    sig_a, sig_b = rng.standard_normal(jc.hop * 8), rng.standard_normal(jc.hop * 8)
    tc, plan, state = _port(jc, rir_a, rir_b, noise)
    final, outs, metrics = run_stream_with_metrics(
        tc, plan, state, torch.from_numpy(sig_a), torch.from_numpy(sig_b), rir_a, rir_b)
    jstate, jouts, jmetrics = jax_run_stream_with_metrics(
        jc, jax_build_plan(jc, rir_a, rir_b), jax_init_state(jc, response_noise=noise),
        jnp.asarray(sig_a), jnp.asarray(sig_b), jnp.asarray(rir_a), jnp.asarray(rir_b))
    for name in ("out_a", "out_b", "out_a_t", "out_b_t"):
        assert _rel(getattr(outs, name), getattr(jouts, name)) <= TOL, name
    for name in METRICS:
        g = getattr(metrics, name)
        assert g.shape[0] == 8, name
        assert _rel(g, getattr(jmetrics, name)) <= TOL, name
    assert _rel(final.out_overlap, jstate.out_overlap) <= TOL
    # The same outputs and final state as run_stream, which it extends.
    final2, outs2 = run_stream(tc, plan, state, torch.from_numpy(sig_a), torch.from_numpy(sig_b))
    assert torch.equal(outs.out_a, outs2.out_a) and torch.equal(final.wresp_stat,
                                                                 final2.wresp_stat)


def test_detectability_matches_jax():
    """The JAX test's 1e8 scaling (tests/test_subsystems.py), both
    functions."""
    tables = build_perceptual_tables(1024, 8000.0, 94.0)
    jtables = jax_build_perceptual_tables(1024, 8000.0, 94.0)
    rng = np.random.default_rng(0)
    masker = rng.standard_normal((3, 1024)) * 0.1
    quiet = rng.standard_normal((3, 1024)) * 1e-6
    loud = quiet * 1e4
    d_quiet = detectability(torch.from_numpy(quiet), torch.from_numpy(masker), tables)
    d_loud = detectability(torch.from_numpy(loud), torch.from_numpy(masker), tables)
    assert d_quiet.shape == (3,) and torch.all(d_loud > d_quiet)
    torch.testing.assert_close(d_loud, d_quiet * 1e8, rtol=1e-6, atol=0)
    for test, d in ((quiet, d_quiet), (loud, d_loud)):
        want = jax_detectability(jnp.asarray(test), jnp.asarray(masker), jtables)
        assert _rel(d, want) <= TOL
    # The model-level form on given spectra and a given squared weighting.
    spec = np.fft.rfft(loud, axis=-1) * tables.spectrum_scale
    w_sq = squared_weighting(torch.from_numpy(np.fft.rfft(masker, axis=-1)),
                             torch.from_numpy(tables.cfmr_sq), tables.cs, tables.ca,
                             tables.leff, tables.spectrum_scale)
    jw_sq = jax_squared_weighting(jnp.asarray(np.fft.rfft(masker, axis=-1)),
                                  jnp.asarray(jtables.cfmr_sq), jtables.cs, jtables.ca,
                                  jtables.leff, jtables.spectrum_scale)
    got = model_detectability(torch.from_numpy(spec), w_sq)
    assert _rel(got, jax_model_detectability(jnp.asarray(spec), jw_sq)) <= TOL
    # The DC bin is left out.
    spec_dc = spec.copy()
    spec_dc[..., 0] += 1e3
    torch.testing.assert_close(model_detectability(torch.from_numpy(spec_dc), w_sq), got,
                               rtol=0, atol=0)


def test_hop_timer():
    timer = HopTimer()
    assert np.isnan(timer.median_ms)
    results = []
    for n in (1, 2, 3):
        with timer.measure(results):
            results.append({"x": torch.ones(n), "y": (torch.zeros(2), None)})
    assert len(timer.samples) == 3 and all(s >= 0 for s in timer.samples)
    assert timer.median_ms == 1000.0 * sorted(timer.samples)[1]
    with timer.measure([]):
        pass
    assert len(timer.samples) == 4
    HopTimer.sync(HopMetrics(*(torch.zeros(1),) * 6))  # CPU tensors: nothing to wait for


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "traces"
    with trace(str(log_dir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in row.key for row in prof.key_averages())


def _checked_verdicts(jc, rir_a, rir_b, poison):
    """(port, JAX) verdicts of one checked hop on the same state and input
    (``poison``: one input sample set to inf)."""
    rng = np.random.default_rng(0)
    noise = _noise(jc, rng)
    a, b = rng.standard_normal(jc.hop), rng.standard_normal(jc.hop)
    if poison:
        a[5] = np.inf
    tc, plan, state = _port(jc, rir_a, rir_b, noise)
    err, (new_state, out) = checked_hop(tc)(plan, state, torch.from_numpy(a),
                                           torch.from_numpy(b))
    jfn = jax.jit(jobs.checked_hop(jc))
    jerr, (_, jout) = jfn(jax_build_plan(jc, rir_a, rir_b),
                          jax_init_state(jc, response_noise=noise), jnp.asarray(a),
                          jnp.asarray(b))
    # The checked hop is the hop: its outputs are process_hop's.
    _, plain = process_hop(tc, plan, state, torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(out.out_a.nan_to_num(), plain.out_a.nan_to_num())
    return err, jerr, out, jout


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "inf-sample"])
def test_checked_hop_verdict_matches_checkify(small_scene, poison):
    jc, rir_a, rir_b = small_scene
    err, jerr, out, jout = _checked_verdicts(jc, rir_a, rir_b, poison)
    assert (err.get() is None) == (jerr.get() is None) == (not poison)
    if poison:
        assert err.get().startswith("nan generated by op: ")
        with pytest.raises(FloatingPointError, match="nan generated"):
            err.throw()
        assert int(out.silenced) == int(jout.silenced) > 0
    else:
        err.throw()
        assert int(out.silenced) == int(jout.silenced) == 0


def test_checked_hop_sees_the_kernels(small_scene):
    """On the production configuration the kernel wrappers call their ops
    under the check, so a kernel is checked as one op (here its plain
    version on the CPU): a clean hop reports nothing and a poisoned input
    is reported at the first op, K1's."""
    jc, rir_a, rir_b = small_scene
    fields = dataclasses.asdict(jc) | production_overrides() | dict(perceptual=True)
    tc = config_from_jax(fields)
    plan, state = build_plan(tc, rir_a, rir_b, "cpu"), init_state(tc, "cpu")
    hop = torch.randn(tc.hop, generator=torch.Generator().manual_seed(0))
    err, _ = checked_hop(tc)(plan, state, hop, hop)
    assert err.get() is None
    bad = hop.clone()
    bad[3] = torch.inf
    err, _ = checked_hop(tc)(plan, state, bad, hop)
    assert err.get() == "nan generated by op: apvast_torch.streaming_conv.default"
