"""The port's frequency-domain engine against the JAX package's, on the CPU.

1. Float64 parity of ``process_hop_fd`` over 6 hops from one carried state
   (the JAX state carried across with ``utils/convert.fd_state_from_numpy``),
   in every mode of the JAX engine: <= 1e-9 of each output's scale. Both
   sides run the same float64 algorithm (LAPACK ``eigh`` and LU solves on
   both), so only rounding separates them; the group solve without a rank
   cutoff is the worst conditioned (a few 1e-10).
2. The float32 ``fd_eigh="jacobi"`` path (K7's plain version; K1's under
   ``use_pallas_conv``) against JAX with its Pallas kernels in interpret
   mode, hop by hop from JAX's state: loudspeaker and target feeds within
   1e-4 of their scale over the hops. Float32 sums in another order; the
   per-bin pencils are whitened fresh every hop, so the six cold sweeps
   see the same matrices on both sides, and on this scene a 1e-7 relative
   change of the statistics moves the feeds by under 1e-6.
3. The whole slice through the entry points: ``ApVastFD.process_signals``
   equals JAX's in float64, and ``process_input_buffers`` hop by hop
   equals ``process_signals``.
4. The errors of the JAX engine and model, word for word; the adjoint of
   the J-tap projection; the state's shapes and its round trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch import ApVastFD
from apvast_torch.engine import build_plan
from apvast_torch.engine.fd_hop import (
    _project_spec,
    _project_spec_adjoint,
    init_fd_state,
    process_hop_fd,
)
from apvast_torch.utils.convert import config_from_jax, fd_state_from_numpy
from apvast_tpu.config import ApVastConfig
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine.fd_hop import init_fd_state as jax_init_fd_state
from apvast_tpu.engine.fd_hop import process_hop_fd as jax_process_hop_fd
from apvast_tpu.models.apvast_fd import ApVastFD as JaxApVastFD
from apvast_tpu.utils.rir import synthetic_rirs
from _torch_dist import one_rank_group
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")


def _scene(num_srcs=4):
    return synthetic_rirs(120, num_srcs, 3, seed=1), synthetic_rirs(120, num_srcs, 3, seed=2)


def _config(rir_a, rir_b, **overrides):
    """The small FD scene: block 128, J = 16, 3 mics, V = S per bin."""
    base = dict(
        block_size=128, filter_length=16, modeling_delay=5, reference_index_a=1,
        reference_index_b=2, num_eigenvectors=rir_a.shape[1], mu=1.0,
        statistics_buffer_length=33, sampling_rate=8000, perceptual=False,
    )
    return ApVastConfig.for_rirs(rir_a, rir_b, **(base | overrides))


def _arrays(state) -> dict:
    return {
        f.name: None if getattr(state, f.name) is None else np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


class _FdPair:
    """One scene, noise and hops through both engines, each hop of the port
    started from JAX's state (``from_jax``) or free-running."""

    def __init__(self, jc, rir_a, rir_b, forgetting=0.9, seed=3):
        self.jc, self.forgetting = jc, forgetting
        self.tc = config_from_jax(dataclasses.asdict(jc))
        self.rng = np.random.default_rng(seed)
        m, s, block, hop = jc.num_mics, jc.num_srcs, jc.block_size, jc.hop
        dt = np.dtype(jc.dtype)
        noise = (1e-3 * self.rng.standard_normal((4, m, s, block)),
                 1e-3 * self.rng.standard_normal((2, m, block)))
        self.jstate = dataclasses.replace(
            jax_init_fd_state(jc),
            resp=jnp.asarray(noise[0][..., hop:].astype(dt)),
            target_resp=jnp.asarray(noise[1][..., hop:].astype(dt)),
        )
        self.state = fd_state_from_numpy(self.tc, _arrays(self.jstate), "cpu")
        self.jplan = jax_build_plan(jc, rir_a, rir_b)
        self.plan = build_plan(self.tc, rir_a, rir_b, "cpu")
        self._jhop = jax.jit(
            lambda st, a, b: jax_process_hop_fd(jc, self.jplan, st, a, b, forgetting=forgetting)
        )
        self.dtype = dt

    def run(self, hops, from_jax=False):
        got, want = [], []
        for _ in range(hops):
            a, b = (self.rng.standard_normal(self.jc.hop).astype(self.dtype) for _ in range(2))
            if from_jax:
                self.state = fd_state_from_numpy(self.tc, _arrays(self.jstate), "cpu")
            self.jstate, jout = self._jhop(self.jstate, jnp.asarray(a), jnp.asarray(b))
            self.state, out = process_hop_fd(
                self.tc, self.plan, self.state, torch.from_numpy(a), torch.from_numpy(b),
                forgetting=self.forgetting,
            )
            assert int(out.silenced) == 0 and int(jout.silenced) == 0
            got.append([getattr(out, f) for f in FIELDS])
            want.append([getattr(jout, f) for f in FIELDS])
        errs = {}
        for i, f in enumerate(FIELDS):
            assert (got[0][i] is None) == (want[0][i] is None), f
            if got[0][i] is None:
                continue
            g = np.stack([np.asarray(h[i]) for h in got])
            w = np.stack([np.asarray(h[i]) for h in want])
            assert g.shape == w.shape, f
            errs[f] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
        return errs


_F64_MODES = {
    "lapack": {},
    "perceptual": dict(perceptual=True),
    "hop32-run-b-off": dict(hop_size=32, run_b=False),
    "full": dict(fd_span="full"),
    "bin-coupling-5": dict(fd_bin_coupling=5),
    "frame-taps-2": dict(fd_frame_taps=2, num_eigenvectors=8),
    "matmul-dft": dict(use_matmul_dft=True, perceptual=True),
    "full-matmul-dft": dict(fd_span="full", use_matmul_dft=True),
    "group-solve": dict(fd_span="full", fd_bin_coupling=5, fd_group_size=3),
    "group-solve-overlap": dict(fd_span="full", fd_bin_coupling=5, fd_group_size=4,
                                fd_group_overlap=True),
    "group-pinv-overlap": dict(fd_span="full", fd_bin_coupling=5, fd_group_size=4,
                               fd_group_rank_tol=1e-3, fd_group_overlap=True),
    "coupled-cg": dict(fd_span="full", fd_bin_coupling=5, fd_coupled_iters=3),
    "coupled-cg-matmul-dft": dict(fd_span="full", fd_bin_coupling=5, fd_coupled_iters=3,
                                  use_matmul_dft=True),
    "coupled-richardson": dict(fd_span="full", fd_bin_coupling=5, fd_coupled_iters=2,
                               fd_coupled_method="richardson"),
    "full-frame-taps-2-coupled": dict(fd_span="full", fd_frame_taps=2, num_eigenvectors=8,
                                      fd_bin_coupling=3, fd_coupled_iters=2),
}


@pytest.mark.parametrize("mode", list(_F64_MODES))
def test_fd_hop_float64_parity(mode):
    rir_a, rir_b = _scene()
    overrides = dict(_F64_MODES[mode])
    if overrides.get("fd_span") == "full":
        overrides.setdefault("num_eigenvectors", 4)
    pair = _FdPair(_config(rir_a, rir_b, **overrides), rir_a, rir_b)
    errs = pair.run(6)
    assert max(errs.values()) <= 1e-9, errs


@pytest.mark.parametrize("taps", [1, 2])
def test_fd_jacobi_float32_matches_jax(taps):
    """The production FD settings of bench.py (forgetting 0.97, matmul DFT,
    K1) in float32 with the Jacobi eigensolver (K7's plain version)."""
    rir_a, rir_b = _scene()
    jc = _config(
        rir_a, rir_b, dtype="float32", perceptual=True, fd_eigh="jacobi",
        fd_jacobi_sweeps=6, fd_frame_taps=taps, num_eigenvectors=4 * taps,
        use_matmul_dft=True, use_pallas_conv=True,
    )
    pair = _FdPair(jc, rir_a, rir_b, forgetting=0.97)
    errs = pair.run(6, from_jax=True)
    assert max(errs.values()) <= 1e-4, errs


def test_fd_jacobi_refuses_float64():
    rir_a, rir_b = _scene()
    jc = _config(rir_a, rir_b, fd_eigh="jacobi")
    tc = config_from_jax(dataclasses.asdict(jc))
    hop = torch.zeros(jc.hop, dtype=torch.float64)
    with pytest.raises(ValueError) as jax_err:
        jax_process_hop_fd(jc, jax_build_plan(jc, rir_a, rir_b), jax_init_fd_state(jc),
                           jnp.zeros(jc.hop), jnp.zeros(jc.hop))
    with pytest.raises(ValueError) as torch_err:
        process_hop_fd(tc, build_plan(tc, rir_a, rir_b, "cpu"), init_fd_state(tc, "cpu"), hop, hop)
    assert str(torch_err.value) == str(jax_err.value)


def _models(rir_a, rir_b, **kwargs):
    args = (128, rir_a, rir_b, 16, 5, 1, 2)
    kwargs = dict(number_of_eigenvectors=4, mu=1.0, sampling_rate=8000, perceptual=True,
                  forgetting=0.95) | kwargs
    return JaxApVastFD(*args, **kwargs), ApVastFD(*args, device="cpu", **kwargs)


@pytest.mark.parametrize("span", ["all", "full"])
def test_apvast_fd_process_signals_equals_jax(span):
    """The slice through its entry point: zero initial noise on both sides
    (JAX's ``key=None``), float64."""
    rir_a, rir_b = _scene()
    jm, tm = _models(rir_a, rir_b, fd_span=span)
    rng = np.random.default_rng(11)
    sig = rng.standard_normal((2, 64 * 7 + 5))
    want = jm.process_signals(sig[0], sig[1])
    got = tm.process_signals(sig[0], sig[1])
    v = 1 if span == "full" else 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (v, 64 * 7, 4)
        assert np.abs(g.numpy() - w).max() <= 1e-9 * np.abs(w).max()
    assert int(tm.silenced) == 0


def test_apvast_fd_buffers_equal_signals():
    rir_a, rir_b = _scene()
    noise = (np.full((4, 3, 4, 128), 1e-3), np.full((2, 3, 128), -1e-3))
    kwargs = dict(number_of_eigenvectors=4, mu=1.0, sampling_rate=8000, device="cpu",
                  response_noise=noise, fd_bin_coupling=3)
    a = ApVastFD(128, rir_a, rir_b, 16, 5, 1, 2, **kwargs)
    b = ApVastFD(128, rir_a, rir_b, 16, 5, 1, 2, **kwargs)
    rng = np.random.default_rng(2)
    sig = rng.standard_normal((2, 64 * 5))
    whole = b.process_signals(sig[0], sig[1])
    hops = [a.process_input_buffers(sig[0, i * 64:(i + 1) * 64], sig[1, i * 64:(i + 1) * 64])
            for i in range(5)]
    for f in range(4):
        stitched = torch.cat([h[f] for h in hops], dim=1)
        torch.testing.assert_close(stitched, whole[f], rtol=0, atol=0)
    a.reset(response_noise=noise)
    torch.testing.assert_close(a.state.cov, torch.zeros_like(a.state.cov), rtol=0, atol=0)
    with pytest.raises(ValueError, match="hop=64"):
        a.process_input_buffers(np.zeros(63), np.zeros(64))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(number_of_eigenvectors=5),
        dict(number_of_eigenvectors=9, fd_frame_taps=2),
    ],
    ids=["rank-cap", "rank-cap-taps-2"],
)
def test_apvast_fd_rank_cap_matches_jax(kwargs):
    rir_a, rir_b = _scene()
    args = (128, rir_a, rir_b, 16, 5, 1, 2)
    kw = dict(mu=1.0, sampling_rate=8000) | kwargs
    with pytest.raises(ValueError) as jax_err:
        JaxApVastFD(*args, **kw)
    with pytest.raises(ValueError) as torch_err:
        ApVastFD(*args, device="cpu", **kw)
    assert str(torch_err.value) == str(jax_err.value)


@pytest.mark.parametrize(
    "overrides",
    [
        dict(fd_span="full", num_eigenvectors=3),
        dict(output_spans=(1, 2)),
        dict(num_eigenvectors=6),
        dict(fd_bin_coupling=131),
    ],
    ids=["full-span-rank", "output-spans", "rank-above-sb", "coupling-wider-than-bins"],
)
def test_fd_hop_errors_match_jax(overrides):
    rir_a, rir_b = _scene()
    jc = _config(rir_a, rir_b, **overrides)
    tc = config_from_jax(dataclasses.asdict(jc))
    with pytest.raises(ValueError) as jax_err:
        jax_process_hop_fd(jc, jax_build_plan(jc, rir_a, rir_b), jax_init_fd_state(jc),
                           jnp.zeros(jc.hop), jnp.zeros(jc.hop))
    hop = torch.zeros(jc.hop, dtype=torch.float64)
    with pytest.raises(ValueError) as torch_err:
        process_hop_fd(tc, build_plan(tc, rir_a, rir_b, "cpu"), init_fd_state(tc, "cpu"), hop, hop)
    assert str(torch_err.value) == str(jax_err.value)


def test_fd_hop_mic_axis_is_not_ported(tmp_path):
    """``mic_axis`` runs (it raised before sharding was ported): with a mic
    group of one rank the hop equals the hop without one bit for bit, and
    the conv kernel with a mic axis raises JAX's ValueError. Sharding over
    several ranks: ``tests/test_torch_sharding.py``."""
    rir_a, rir_b = _scene()
    jc = _config(rir_a, rir_b, use_pallas_conv=True, dtype="float32")
    tc = config_from_jax(dataclasses.asdict(jc))
    hop = torch.zeros(jc.hop)
    with pytest.raises(ValueError, match="mic sharding"):
        process_hop_fd(tc, build_plan(tc, rir_a, rir_b, "cpu"), init_fd_state(tc, "cpu"),
                       hop, hop, mic_axis=object())
    tc = dataclasses.replace(tc, use_pallas_conv=False)
    plan = build_plan(tc, rir_a, rir_b, "cpu")
    state = init_fd_state(tc, "cpu", generator=torch.Generator().manual_seed(0))
    a, b = torch.randn(2, jc.hop, generator=torch.Generator().manual_seed(1))
    want_state, want = process_hop_fd(tc, plan, state, a, b)
    with one_rank_group(tmp_path) as group:
        got_state, got = process_hop_fd(tc, plan, state, a, b, mic_axis=group)
    for name in ("out_a", "out_b", "out_a_t", "out_b_t"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got_state.cov, want_state.cov)


@pytest.mark.parametrize("matmul_dft", [False, True])
def test_projection_adjoint(matmul_dft):
    """<K x, y> = <x, K^adj y> in the real inner product Re sum conj(a) b,
    for both forms of the J-tap projection K, and K is idempotent."""
    rir_a, rir_b = _scene()
    jc = _config(rir_a, rir_b, use_matmul_dft=matmul_dft)
    tc = config_from_jax(dataclasses.asdict(jc))
    plan = build_plan(tc, rir_a, rir_b, "cpu")
    g = torch.Generator().manual_seed(0)
    x, y = (torch.randn((3, 4, tc.num_bins), generator=g, dtype=torch.complex128)
            for _ in range(2))

    def inner(a, b):
        return float((a.conj() * b).real.sum())

    kx = _project_spec(tc, plan, x)
    lhs, rhs = inner(kx, y), inner(x, _project_spec_adjoint(tc, plan, y))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    torch.testing.assert_close(_project_spec(tc, plan, kx), kx, rtol=0, atol=1e-12)


@pytest.mark.parametrize("taps", [1, 2])
def test_fd_state_equals_jax_and_round_trips(taps):
    rir_a, rir_b = _scene()
    jc = _config(rir_a, rir_b, fd_frame_taps=taps, num_eigenvectors=4 * taps, dtype="float32")
    tc = config_from_jax(dataclasses.asdict(jc))
    want = _arrays(jax_init_fd_state(jc))
    got = init_fd_state(tc, "cpu")
    for name, w in want.items():
        g = getattr(got, name)
        absent = taps == 1 and name.endswith("spec_hist")
        assert (g is None) == absent and (w is None) == absent, name
        if g is not None:
            assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g.numpy(), w)
    carried = fd_state_from_numpy(tc, want, "cpu")
    for name, w in want.items():
        if w is not None:
            np.testing.assert_array_equal(getattr(carried, name).numpy(), w)
    with pytest.raises(ValueError, match="cov"):
        fd_state_from_numpy(tc, want | {"cov": want["cov"][:, 1:]}, "cpu")
    if taps == 1:
        with pytest.raises(ValueError, match="fd_frame_taps > 1"):
            fd_state_from_numpy(tc, want | {"spec_hist": np.zeros(1)}, "cpu")
    with pytest.raises(ValueError, match="does not have"):
        fd_state_from_numpy(tc, want | {"wresp_stat": np.zeros(1)}, "cpu")


def test_fd_state_noise_from_generator():
    rir_a, rir_b = _scene()
    tc = config_from_jax(dataclasses.asdict(_config(rir_a, rir_b)))
    s1 = init_fd_state(tc, "cpu", generator=torch.Generator().manual_seed(4))
    s2 = init_fd_state(tc, "cpu", generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(s1.resp, s2.resp, rtol=0, atol=0)
    assert 0 < float(s1.resp.std()) < 1e-2 and s1.resp.shape == (4, 3, 4, 64)
    assert float(init_fd_state(tc, "cpu").resp.abs().max()) == 0.0


def test_apvast_fd_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rir_a, rir_b = _scene()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ApVastFD(128, rir_a, rir_b, 16, 5, 1, 2, 4, 1.0, sampling_rate=8000)


def test_unvalidated_fd_eigh_in_float64_is_refused():
    """A fault of the JAX package (ROADMAP.md Queue 3): ``fd_eigh`` is not
    validated, any value but "lapack" runs the float32 Jacobi kernel, and
    the float64 guard tests only "jacobi", so ``fd_eigh="x"`` runs a
    float64 config through float32 silently. The port's K7 wrapper takes
    complex64 only and raises."""
    rir_a, rir_b = _scene()
    jc = _config(rir_a, rir_b, fd_eigh="x")
    _, out = jax_process_hop_fd(jc, jax_build_plan(jc, rir_a, rir_b), jax_init_fd_state(jc),
                                jnp.ones(jc.hop), jnp.ones(jc.hop))
    assert np.isfinite(np.asarray(out.out_a)).all()
    tc = config_from_jax(dataclasses.asdict(jc))
    hop = torch.ones(jc.hop, dtype=torch.float64)
    with pytest.raises(ValueError, match="complex64"):
        process_hop_fd(tc, build_plan(tc, rir_a, rir_b, "cpu"), init_fd_state(tc, "cpu"), hop, hop)


def test_singular_group_system_gives_nans_not_an_error():
    """JAX's LU solve returns non-finite values for a singular system, which
    the hop's ``silenced`` count sees; ``torch.linalg.solve`` would raise.
    A regular system beside it is solved."""
    from apvast_torch.engine.fd_hop import _solve

    h = torch.stack([torch.zeros(3, 3, dtype=torch.complex128),
                     2 * torch.eye(3, dtype=torch.complex128)])
    x = _solve(h, torch.ones(2, 3, 1, dtype=torch.complex128))
    assert torch.isnan(x[0]).all()
    torch.testing.assert_close(x[1], torch.full((3, 1), 0.5, dtype=torch.complex128))
    want = np.asarray(jnp.linalg.solve(jnp.asarray(h.numpy()), jnp.ones((2, 3, 1))))
    assert not np.isfinite(want[0]).all()
