"""The port on a CUDA device: each kernel wrapper against its plain version
at ragged shapes, its launch count, its input checks on the card, and the
hop on the card (exact, production and 'invert' solver, the dense
statistics with K6, the truncated weighting with K8, and the
frequency-domain engine with K7) against the same hop on the CPU.

Needs a card: every test is marked ``cuda`` and skips without one. This
file imports neither JAX nor the shared fixtures, so on a machine without
JAX it runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: kernel and plain version both sum in float32 and may order
the sums differently (1e-4 of the output scale; K4 on warm-start-like
inputs, where no rotation pair sits at theta ~ 0; K7 on what does not
depend on the phase that rounding picks inside each doubled eigenvalue of
its real embedding: eigenvalues, residual, orthonormality); hop outputs as in
tests/test_torch_hop.py (statistics 1e-4, target feeds 1e-5, loudspeaker
feeds 5e-2 of the signal scale), the production hop compared hop by hop
from the card's state (tests/test_torch_tracking.py says why).
"""

import dataclasses

import numpy as np
import pytest
import torch

from apvast_torch import ApVast, ApVastFD, GevdSolver, production_overrides
from apvast_torch.engine import hop_statistics, process_hop, process_hop_fd
from apvast_torch.ops import kernels as K
from apvast_torch.utils.rir import synthetic_rirs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = (x.cdouble().cpu() if x.is_complex() else x.double().cpu() for x in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _warm(rnd, b, n):
    e = 1e-2 * rnd(b, n, n)
    return torch.diag_embed(torch.linspace(-3.0, 5.0, n, device=e.device).repeat(b, 1)) + (
        e + e.transpose(1, 2)
    ) / 2


def _spd(rnd, b, n):
    x = rnd(b, n, n)
    return (x @ x.transpose(1, 2) / n + torch.eye(n, device=x.device)).contiguous()


def _subspace_args(rnd, b, n, k, iters):
    """a SPD, li the inverse Cholesky factor of an SPD matrix, q0 random."""
    li = torch.linalg.inv(torch.linalg.cholesky(_spd(rnd, b, n)))
    return (_spd(rnd, b, n), li.contiguous(), rnd(b, n, k), iters)


def _herm(rnd, b, n):
    x = torch.complex(rnd(b, n, n), rnd(b, n, n))
    return ((x + x.conj().transpose(1, 2)) / 2).contiguous()


def _cases(rnd):
    return {
        "streaming_conv": [
            (rnd(2, 300), rnd(2, 37, 77), 50),
            (rnd(1, 129), rnd(1, 33, 65), 65),
        ],
        "lag_corr": [(rnd(4, 3, 5, 70), 9), (rnd(4, 2, 33, 120), 40), (rnd(2, 1, 1, 10), 1)],
        "skew_assembly": [
            (rnd(4, 45, 6), rnd(4, 6, 45), rnd(4, 5, 45), 9),
            (rnd(2, 33 * 3, 4), rnd(2, 4, 33 * 3), rnd(2, 33, 99), 3),
            (rnd(4, 45, 6), rnd(4, 6, 45), rnd(4, 5, 45), 9, True),
            (rnd(2, 33 * 3, 4), rnd(2, 4, 33 * 3), rnd(2, 33, 99), 3, True),
        ],
        "whiten": [(_spd(rnd, 2, 128),), (_spd(rnd, 1, 128),), (_spd(rnd, 3, 128),)],
        "subspace": [
            _subspace_args(rnd, 2, 96, 16, 2),
            _subspace_args(rnd, 2, 200, 24, 2),
            _subspace_args(rnd, 3, 50, 8, 1),
            _subspace_args(rnd, 1, 40, 16, 0),
        ],
        "jacobi_eigh": [
            (_warm(rnd, 2, 64), 2),
            (_warm(rnd, 3, 10), 2),
            (_warm(rnd, 5, 37), 8),
            (_warm(rnd, 1, 128), 2),
        ],
        "jacobi_eigh_hermitian": [
            (_herm(rnd, 3, 5), 10),
            (_herm(rnd, 40, 16), 10),
            (_herm(rnd, 2, 32), 12),
            (_herm(rnd, 1, 1), 2),
        ],
        "output_filter": [
            (rnd(2, 100), rnd(2, 37, 9), rnd(100), rnd(2, 37, 70), 30),
            (rnd(2, 100), rnd(2, 37, 9), rnd(100), rnd(2, 37, 40), 60),
            (rnd(1, 50), rnd(1, 17, 50), rnd(50), rnd(1, 17, 0), 50),
        ],
        # Rows (2S) past one 32-row pass, frames wider than one 32-output tile.
        "rowwise_conv": [
            (rnd(4, 2, 3, 64), rnd(2, 2, 16, 24), 9, 16),
            (rnd(4, 3, 5, 90), rnd(2, 3, 30, 40), 11, 30),
            (rnd(4, 2, 17, 96), rnd(2, 2, 48, 54), 7, 48),
        ],
        # SJ filling no 64-row tile, SJ past three tiles, SJ = 1.
        "statistics": [
            (rnd(4, 3, 4, 96), rnd(2, 3, 89), 8),
            (rnd(2, 2, 3, 200), rnd(2, 2, 101), 100),
            (rnd(1, 1, 1, 10), rnd(2, 1, 10), 1),
        ],
        "circular_filter": [
            (rnd(2, 100), rnd(2, 37, 9)),
            (rnd(1, 64), rnd(1, 5, 64)),
            (rnd(2, 1600), rnd(2, 33, 50)),
        ],
    }


_PLAIN = {
    "streaming_conv": K.streaming_conv_plain,
    "lag_corr": K.lag_corr_plain,
    "skew_assembly": K.lag_skew_assemble_plain,
    "whiten": K.chol_panel_plain,
    "subspace": K.subspace_iterate_plain,
    "jacobi_eigh": K.jacobi_eigh_plain,
    "output_filter": K.circular_filter_overlap_plain,
    "jacobi_eigh_hermitian": K.jacobi_eigh_hermitian_plain,
    "rowwise_conv": K.rowwise_circular_conv_plain,
    "statistics": K.covariance_plain,
    "circular_filter": K.circular_filter_plain,
}


def _hermitian_state(h, w, q):
    """K7's phase-free state: max |Hq - qw| / max |H| and max |q^H q - I|."""
    h, q = h.cdouble(), q.cdouble()
    res = (h @ q - q * w.double()[:, None, :]).abs().max() / h.abs().max()
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return float(res), float((q.conj().transpose(1, 2) @ q - eye).abs().max())


@pytest.mark.parametrize("name", list(K.WRAPPERS))
def test_kernel_matches_plain_on_the_card(dev, name):
    g = torch.Generator().manual_seed(7)
    cases = _cases(lambda *s: torch.randn(s, generator=g).to(dev))[name]
    wrapper = K.WRAPPERS[name]
    before = wrapper.launches
    for args in cases:
        got, want = wrapper(*args), _PLAIN[name](*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if name == "jacobi_eigh_hermitian":
            # Eigenvalues; the eigenvectors up to their phase.
            assert _rel(got[0], want[0]) <= 1e-4
            assert max(_hermitian_state(args[0], *got)) <= 1e-4
            assert got[1].shape == want[1].shape and got[1].device.type == "cuda"
            continue
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and a.shape == b.shape
            if b.numel():
                assert _rel(a, b) <= 1e-4
    assert wrapper.launches == before + len(cases)


def test_whiten_kernel_non_pd_panel_is_non_finite(dev):
    """A negative pivot overflows the factor, as in JAX, so the solver's
    silenced count sees it; the SPD panel beside it stays exact."""
    g = torch.Generator().manual_seed(3)
    d = _spd(lambda *s: torch.randn(s, generator=g).to(dev), 2, 128)
    d[1, 70, 70] = -1.0
    l, inv = K.chol_panel(d)
    torch.cuda.synchronize()
    assert torch.isfinite(l[0]).all() and torch.isfinite(inv[0]).all()
    assert not torch.isfinite(l[1]).all() and not torch.isfinite(inv[1]).all()
    assert (torch.triu(l[0], 1) == 0).all() and (torch.triu(inv[0], 1) == 0).all()


def test_kernels_refuse_float64_on_the_card(dev):
    x = torch.zeros(4, 2, 3, 30, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        K.lag_corr(x, 5)
    with pytest.raises(ValueError, match="is on"):
        K.streaming_conv(torch.zeros(2, 100, device=dev), torch.zeros(2, 3, 20), 40)


def _s8_kwargs(rng, overrides):
    rir_a, rir_b = synthetic_rirs(96, 8, 3, seed=81), synthetic_rirs(96, 8, 3, seed=82)
    noise = (1e-3 * rng.standard_normal((4, 3, 8, 128)), 1e-3 * rng.standard_normal((2, 3, 128)))
    return dict(
        block_size=128, rir_a=rir_a, rir_b=rir_b, filter_length=12, modeling_delay=4,
        reference_index_a=0, reference_index_b=5, number_of_eigenvectors=8, mu=1.0,
        statistics_buffer_length=128, sampling_rate=8000, perceptual=True,
        response_noise=noise, **overrides,
    )


def test_slice_hop_on_the_card_matches_cpu(dev):
    rng = np.random.default_rng(9)
    kwargs = _s8_kwargs(rng, production_overrides() | {"gevd_solver": GevdSolver.EIGH})
    card, cpu = ApVast(device=dev, **kwargs), ApVast(device="cpu", **kwargs)
    K.reset_launch_counts()
    hops = rng.standard_normal((6, 2, 64)).astype(np.float32)
    got = [card.process_input_buffers(a, b) for a, b in hops]
    path = ("streaming_conv", "lag_corr", "skew_assembly", "output_filter")
    assert K.launch_counts() == {name: 6 if name in path else 0 for name in K.WRAPPERS}
    want = [cpu.process_input_buffers(a, b) for a, b in hops]
    assert int(card.silenced) == 0
    for f in range(4):
        g = torch.stack([x[f] for x in got])
        w = torch.stack([x[f] for x in want])
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= (1e-5 if f >= 2 else 5e-2)
    for a, b in zip(
        hop_statistics(card.config, card.state.wresp_stat, card.state.wtarget_stat),
        hop_statistics(cpu.config, cpu.state.wresp_stat, cpu.state.wtarget_stat),
    ):
        assert _rel(a, b) <= 1e-4


def _state_to(state, device):
    return dataclasses.replace(
        state,
        **{
            f.name: getattr(state, f.name).to(device)
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)
        },
    )


# K4 at 8 sweeps: at the round-3 solvers' 2-3 sweeps it is unconverged on
# their Rayleigh-Ritz matrices, and card and CPU then part by rounding
# (chip_smoke.py, CONVERGED_SWEEPS).
_INVERT = {"subspace_whiten": "invert", "jacobi_sweeps": 8, "subspace_oversample": 8,
           "use_pallas_subspace": True, "use_pallas_whiten": True}


_PRODUCTION_KERNELS = ("streaming_conv", "lag_corr", "skew_assembly", "jacobi_eigh",
                       "output_filter")
# Each configuration's overrides of production_overrides() and the kernels
# its hop launches once.
_CARD_PATHS = {
    "production": ({}, _PRODUCTION_KERNELS),
    "invert": (_INVERT, _PRODUCTION_KERNELS + ("whiten", "subspace")),
    "dense": ({"use_lag_statistics": False},
              ("streaming_conv", "statistics", "jacobi_eigh", "output_filter")),
    "weighting-conv": ({"weighting_conv_taps": 31}, _PRODUCTION_KERNELS + ("rowwise_conv",)),
}


@pytest.mark.parametrize("config", list(_CARD_PATHS))
def test_production_hop_on_the_card_matches_cpu(dev, config):
    """The production configuration launches its five kernels every hop,
    the 'invert' one (k = 16, JL = 96: one panel) all seven, the dense one
    K6 in place of K2 and K3, the truncated weighting K8 besides the five;
    each card hop equals the CPU hop from the same state."""
    rng = np.random.default_rng(10)
    overrides, kernels = _CARD_PATHS[config]
    kwargs = _s8_kwargs(rng, production_overrides() | overrides)
    card = ApVast(device=dev, **kwargs)
    cpu = ApVast(device="cpu", **kwargs)
    K.reset_launch_counts()
    for hop, (a, b) in enumerate(rng.standard_normal((8, 2, 64)).astype(np.float32)):
        start = _state_to(card.state, "cpu")
        got = card.process_input_buffers(a, b)
        cpu.state, want = process_hop(
            cpu.config, cpu.plan, start, torch.from_numpy(a), torch.from_numpy(b)
        )
        # On this scene's first hop the statistics hold only the initial
        # noise, and the dark matrix is so ill-conditioned that its float32
        # explicit inverse factor is far from the float64 one on either
        # device; 'invert' whitens with it, so its first-hop feeds depend
        # on the summation order. The later hops are held to 5e-2.
        cold_invert = config == "invert" and hop == 0
        for f, name in enumerate(("out_a", "out_b", "out_a_t", "out_b_t")):
            w = getattr(want, name)
            assert torch.isfinite(got[f]).all()
            if name.endswith("_t"):
                assert _rel(got[f], w) <= 1e-5, name
            elif not cold_invert:
                assert _rel(got[f], w) <= 5e-2, name
        # The card's buffers, through the CPU statistics (no launches).
        for x, y in zip(
            hop_statistics(card.config, card.state.wresp_stat.cpu(), card.state.wtarget_stat.cpu()),
            hop_statistics(cpu.config, cpu.state.wresp_stat, cpu.state.wtarget_stat),
        ):
            assert _rel(x, y) <= 1e-4
    assert K.launch_counts() == {name: 8 if name in kernels else 0 for name in K.WRAPPERS}
    assert int(card.silenced) == 0
    if config != "invert":
        assert card.rebuilds >= 6  # warmup, then the residual trigger


def test_hermitian_kernel_degenerate_pairs(dev):
    """Two exact 2-fold degeneracies and a pair 1 float32 ulp apart
    (tests/test_jacobi_eigh.py): the repair keeps the columns orthonormal
    on the card as in the plain version."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((6, 8, 8)) + 1j * rng.standard_normal((6, 8, 8))
    q, _ = np.linalg.qr(z)
    w0 = np.array([1.0, 1.0, 2.0, 2.0, 3.0, np.float32(3.0) + np.spacing(np.float32(3.0)),
                   5.0, 8.0])
    a = (q * w0.astype(q.dtype)) @ np.conj(q.swapaxes(-1, -2))
    h = torch.from_numpy((0.5 * (a + np.conj(a.swapaxes(-1, -2)))).astype(np.complex64)).to(dev)
    w, v = K.jacobi_eigh_hermitian(h, 10)
    wp, _ = K.jacobi_eigh_hermitian_plain(h, 10)
    assert _rel(w, wp) <= 1e-4
    res, orth = _hermitian_state(h, w, v)
    assert res <= 1e-3 and orth <= 5e-3


@pytest.mark.parametrize("span", ["all", "full"])
def test_fd_hop_on_the_card_matches_cpu(dev, span):
    """ApVastFD with bench.py's FD settings on tests/test_torch_fd.py's
    scene (S = 4, 3 mics): K1 every hop and, under fd_eigh='jacobi', K7
    every hop; each card hop equals the CPU hop from the same state
    (statistics and target feeds 1e-4 of their scale; loudspeaker feeds
    1e-3: on the CPU the port and JAX agree within 5e-5 there, and a 1e-7
    relative change of the statistics moves them by under 1e-6)."""
    rng = np.random.default_rng(12)
    noise = (1e-3 * rng.standard_normal((4, 3, 4, 128)), 1e-3 * rng.standard_normal((2, 3, 128)))
    kwargs = dict(
        block_size=128, rir_a=synthetic_rirs(120, 4, 3, seed=1),
        rir_b=synthetic_rirs(120, 4, 3, seed=2), filter_length=16, modeling_delay=5,
        reference_index_a=1, reference_index_b=2, number_of_eigenvectors=4, mu=1.0,
        sampling_rate=8000, perceptual=True, response_noise=noise, dtype="float32",
        use_matmul_dft=True, use_pallas_conv=True, fd_span=span, fd_eigh="jacobi",
    )
    card = ApVastFD(device=dev, forgetting=0.97, **kwargs)
    cpu = ApVastFD(device="cpu", forgetting=0.97, **kwargs)
    K.reset_launch_counts()
    got, want = [], []
    for a, b in rng.standard_normal((6, 2, 64)).astype(np.float32):
        start = _state_to(card.state, "cpu")
        got.append(card.process_input_buffers(a, b))
        cpu.state, out = process_hop_fd(cpu.config, cpu.plan, start, torch.from_numpy(a),
                                        torch.from_numpy(b), forgetting=0.97)
        want.append((out.out_a, out.out_b, out.out_a_t, out.out_b_t))
        assert _rel(card.state.cov, cpu.state.cov) <= 1e-4
        assert _rel(card.state.cross, cpu.state.cross) <= 1e-4
    counts = {name: 0 for name in K.WRAPPERS} | {"streaming_conv": 6}
    assert K.launch_counts() == counts | {"jacobi_eigh_hermitian": 6 if span == "all" else 0}
    assert int(card.silenced) == 0
    for f in range(4):
        g = torch.stack([x[f] for x in got])
        w = torch.stack([x[f].expand_as(g[0]) for x in want])
        assert torch.isfinite(g).all() and _rel(g, w) <= (1e-4 if f >= 2 else 1e-3)
