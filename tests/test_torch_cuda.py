"""The port on a CUDA device: each kernel wrapper against its plain version
at ragged shapes, its launch count, its input checks on the card; K1 and
K6 (3xTF32 on the tensor cores) against a float64 oracle, on views with a
storage offset, and K6's exact symmetry and repeatability; and the hop on
the card (exact, production and 'invert' solver, the dense
statistics with K6, the truncated weighting with K8, and the
frequency-domain engine with K7) against the same hop on the CPU.

Needs a card: every test is marked ``cuda`` and skips without one. This
file imports neither JAX nor the shared fixtures, so on a machine without
JAX it runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: kernel and plain version both sum in float32 and may order
the sums differently (1e-4 of the output scale; K4 on warm-start-like
inputs, where no rotation pair sits at theta ~ 0; K7 on what does not
depend on the phase that rounding picks inside each doubled eigenvalue of
its real embedding: eigenvalues, residual, orthonormality); K1 and K6
against float64 within twice the plain float32 version's own error; hop
outputs as in tests/test_torch_hop.py (statistics 1e-4, target feeds 1e-5,
loudspeaker feeds 5e-2 of each hop's scale), the production hop compared
hop by hop from the card's state (tests/test_torch_tracking.py says why).
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
        # One panel, the padding path, the main path's shape.
        "chol_tri_inverse": [(_spd(rnd, 2, 128),), (_spd(rnd, 1, 200),), (_spd(rnd, 2, 800),)],
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
    "chol_tri_inverse": K.chol_tri_inverse_plain,
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


def test_chol_tri_inverse_non_pd_is_non_finite(dev):
    """K10b: a negative pivot gives non-finite rows from its sub-panel down,
    the SPD matrix beside it stays finite, and both keep exact zeros above
    the diagonal."""
    g = torch.Generator().manual_seed(4)
    b = _spd(lambda *s: torch.randn(s, generator=g).to(dev), 2, 300)
    b[1, 150, 150] = -1.0
    x = K.chol_tri_inverse(b)
    torch.cuda.synchronize()
    assert torch.isfinite(x[0]).all() and not torch.isfinite(x[1]).all()
    assert torch.isfinite(x[1, :128]).all()
    assert (torch.triu(x, 1) == 0).all()


def _eigen_state(a, w, v):
    """max |A v - v w| / max |A| and max |V^T V - I| (V^H V for complex),
    in double precision."""
    if a.is_complex():
        return _hermitian_state(a, w, v)
    a, v = a.double(), v.double()
    res = (a @ v - v * w.double()[:, None, :]).abs().max() / a.abs().max()
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    return float(res), float((v.transpose(1, 2) @ v - eye).abs().max())


@pytest.mark.parametrize(
    "shape,complex_",
    [((2, 136), False), ((2, 200), False), ((4, 72), True), ((2, 100), True)],
    ids=["real-136", "real-200-global", "complex-72", "complex-100-global"],
)
def test_jacobi_wide_forms_match_plain(dev, shape, complex_):
    """Past 128 slots: the single-buffered 512-thread form (136, and 144
    for complex 72) and the global-memory form (200 slots), on
    warm-start-like inputs: eight cold sweeps leave close pairs of a random
    144-slot matrix unconverged on either side, and rounding picks them. At
    8 sweeps the eigenvalues agree to 1e-4 of scale; the eigenvectors of
    close eigenvalues carry the rounding of ~1600 rounds (2.2e-4 of scale
    apart at 136-200 slots), so they are held by their residual and
    orthonormality, within the larger of 1e-4 and 1.5x the plain
    version's, as K7's are."""
    g = torch.Generator().manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=g).to(dev)  # noqa: E731
    a = _warm(rnd, *shape)
    if complex_:
        a = a.to(torch.complex64) + 1e-2 * _herm(rnd, *shape)
    a = a.contiguous()
    fn, plain = ((K.jacobi_eigh_hermitian, K.jacobi_eigh_hermitian_plain) if complex_
                 else (K.jacobi_eigh, K.jacobi_eigh_plain))
    before = fn.launches
    (w, v), (wp, vp) = fn(a, 8), plain(a, 8)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and v.shape == vp.shape
    assert _rel(w, wp) <= 1e-4
    for got, want in zip(_eigen_state(a, w, v), _eigen_state(a, wp, vp)):
        assert got <= max(1e-4, 1.5 * want)


@pytest.mark.parametrize("n", [16, 32], ids=["32-slots", "64-slots"])
def test_hermitian_matches_k4_on_the_embedding(dev, n):
    """K7 (the pair-block form) at 32 and 64 slots runs the rotations of
    K4's kernel on the real embedding with select_pairs: on six cold sweeps
    of random pencils the eigenvalues agree to 1e-5 of scale (rounding
    only: the contractions of each entry are the same), and the residual
    and orthonormality within the larger of 1e-4 and 1.5x the embedding's
    (six sweeps leave close pairs unconverged on both)."""
    from apvast_torch.ops.kernels.jacobi_eigh_hermitian import embed, select_pairs

    g = torch.Generator().manual_seed(13)
    h = _herm(lambda *s: torch.randn(s, generator=g).to(dev), 64, n)
    before = K.jacobi_eigh_hermitian.launches
    w, q = K.jacobi_eigh_hermitian(h, 6)
    assert K.jacobi_eigh_hermitian.launches == before + 1
    w_ref, q_ref = select_pairs(*K.jacobi_eigh(embed(h), 6), n)
    torch.cuda.synchronize()
    assert _rel(w, w_ref) <= 1e-5
    for got, want in zip(_hermitian_state(h, w, q), _hermitian_state(h, w_ref, q_ref)):
        assert got <= max(1e-4, 1.5 * want)


def test_jacobi_production_shape_matches_plain(dev):
    """K4 at the tracking solver's shape, (2, 64, 64) at 2 sweeps on a
    warm-start-like input, equals its plain version within 1e-4."""
    g = torch.Generator().manual_seed(17)
    a = _warm(lambda *s: torch.randn(s, generator=g).to(dev), 2, 64).contiguous()
    got, want = K.jacobi_eigh(a, 2), K.jacobi_eigh_plain(a, 2)
    torch.cuda.synchronize()
    assert _rel(got[0], want[0]) <= 1e-4 and _rel(got[1], want[1]) <= 1e-4


def _rowwise_inputs(dev, seed):
    """The truncated weighting's shapes, cut in mics: x (4, 2, 16, 1600)
    and a random (non-banded) k_t of T = 257, B = 160."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((4, 2, 16, 1600), generator=g).to(dev)
    k_t = torch.randn((2, 2, 160, 416), generator=g).to(dev)
    return x, k_t


def test_rowwise_conv_matches_float64_oracle(dev):
    x, k_t = _rowwise_inputs(dev, 19)
    got = K.rowwise_circular_conv(x, k_t, 257, 160)
    want = K.rowwise_circular_conv_plain(x.double(), k_t.double(), 257, 160)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5


def test_rowwise_conv_offset_views_match_plain(dev):
    """Contiguous views whose storage starts one float past a 16-byte
    boundary (x, k_t, or both) take the element-wise staging and equal the
    plain version, as the aligned inputs do."""
    x, k_t = _rowwise_inputs(dev, 29)
    x_off = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x).copy_(x)
    k_off = torch.empty(k_t.numel() + 1, device=dev)[1:].view_as(k_t).copy_(k_t)
    want = K.rowwise_circular_conv_plain(x, k_t, 257, 160)
    for xi, ki in ((x_off, k_t), (x, k_off), (x_off, k_off)):
        assert xi.is_contiguous() and ki.is_contiguous()
        got = K.rowwise_circular_conv(xi, ki, 257, 160)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-4


def test_rowwise_conv_propagates_nan_as_plain(dev):
    """One NaN sample reaches every output of each frame whose full-depth
    window (with the circular halo) holds it, and no other."""
    x, k_t = _rowwise_inputs(dev, 23)
    x[1, 0, 3, 5] = float("nan")  # in the halo of the last frame, wrapped
    got = K.rowwise_circular_conv(x, k_t, 257, 160)
    want = K.rowwise_circular_conv_plain(x, k_t, 257, 160)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[1, 0, 3]).sum() == 2 * 160  # frames 0 and 9
    assert torch.isnan(got).sum() == 2 * 160
    finite = ~torch.isnan(want)
    assert _rel(got[finite], want[finite]) <= 1e-4


# K1 and K6 run their products on the tensor cores in 3xTF32: the north-star
# shapes and the ragged ones of test_kernel_matches_plain_on_the_card.
_TF32X3_CASES = {
    "k1 north star": ("streaming_conv", ((2, 4096), (2, 561, 2400)), 800),
    "k1 ragged": ("streaming_conv", ((2, 300), (2, 37, 77)), 50),
    "k6 north star": ("statistics", ((4, 17, 16, 999), (2, 17, 950)), 50),
    "k6 ragged": ("statistics", ((4, 3, 4, 96), (2, 3, 89)), 8),
    "k6 ragged sj 300": ("statistics", ((2, 2, 3, 200), (2, 2, 101)), 100),
}


def _tf32x3_inputs(dev, case, seed):
    name, shapes, arg = _TF32X3_CASES[case]
    g = torch.Generator().manual_seed(seed)
    return name, [torch.randn(s, generator=g).to(dev) for s in shapes], arg


@pytest.mark.parametrize("case", list(_TF32X3_CASES))
def test_tf32x3_kernels_within_twice_plain_error_against_float64(dev, case):
    """K1 and K6 against a float64 oracle (the plain version in float64 on
    the card): per output, within 2x the plain float32 version's own error,
    and within 1e-4 of the plain version's scale."""
    name, args, arg = _tf32x3_inputs(dev, case, 41)
    got = K.WRAPPERS[name](*args, arg)
    want = _PLAIN[name](*args, arg)
    oracle = _PLAIN[name](*(a.double() for a in args), arg)
    torch.cuda.synchronize()
    got, want, oracle = (x if isinstance(x, tuple) else (x,) for x in (got, want, oracle))
    for x, w, o in zip(got, want, oracle):
        assert _rel(x, w) <= 1e-4
        assert _rel(x, o) <= 2 * _rel(w, o), (_rel(x, o), _rel(w, o))


@pytest.mark.parametrize("name", ["streaming_conv", "statistics"])
def test_tf32x3_kernels_on_offset_views_match_plain(dev, name):
    """Contiguous views whose storage starts one float past a 16-byte
    boundary (each input, then all) equal the plain version, as aligned
    inputs do: no copy may assume an aligned start."""
    case = "k1 ragged" if name == "streaming_conv" else "k6 ragged"
    _, args, arg = _tf32x3_inputs(dev, case, 43)
    want = _PLAIN[name](*args, arg)
    want = want if isinstance(want, tuple) else (want,)
    offset = [torch.empty(a.numel() + 1, device=dev)[1:].view_as(a).copy_(a) for a in args]
    for views in ([offset[0], args[1]], [args[0], offset[1]], offset):
        assert all(v.is_contiguous() for v in views)
        got = K.WRAPPERS[name](*views, arg)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        for x, w in zip(got, want):
            assert _rel(x, w) <= 1e-4


@pytest.mark.parametrize("case", ["k6 north star", "k6 ragged", "k6 ragged sj 300"])
def test_statistics_exactly_symmetric_and_repeatable(dev, case):
    """K6's R equals its transpose bit for bit, and two launches on the
    same inputs give the same bits (no atomics, no sum across blocks)."""
    _, args, arg = _tf32x3_inputs(dev, case, 47)
    r1, c1 = K.covariance(*args, arg)
    r2, c2 = K.covariance(*args, arg)
    torch.cuda.synchronize()
    assert torch.equal(r1, r1.transpose(1, 2))
    assert torch.equal(r1, r2) and torch.equal(c1, c2)


def test_streaming_conv_propagates_nan_as_plain(dev):
    """A NaN segment sample reaches the outputs whose window holds it, and
    not those whose window ends just past it, which the last (ragged) tap
    chunk stages too."""
    _, (seg, kern), hop = _tf32x3_inputs(dev, "k1 ragged", 53)
    hist, taps = seg.shape[1] - hop, kern.shape[2]
    seg[1, hist - taps + 6] = float("nan")  # in the windows of outputs 0-5
    got = K.streaming_conv(seg, kern, hop)
    want = K.streaming_conv_plain(seg, kern, hop)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got).sum() == 6 * kern.shape[1]
    finite = ~torch.isnan(want)
    assert _rel(got[finite], want[finite]) <= 1e-4


def test_statistics_propagates_nan_as_plain(dev):
    """A NaN buffer sample reaches R's rows and columns, and r's rows, of
    the window rows that hold it, and no other: the newest sample lies in
    one row's window, and past K in the last chunk the other rows of its
    source stage it too; the oldest also lies in one row's window."""
    _, (buf, tgt), j = _tf32x3_inputs(dev, "k6 ragged", 59)
    buf[1, 2, 3, -1] = float("nan")  # row 3 J of path 1
    buf[2, 0, 1, 0] = float("nan")  # row 2 J - 1 of path 2
    r_mats, r_cross = K.covariance(buf, tgt, j)
    want_r, want_c = K.covariance_plain(buf, tgt, j)
    torch.cuda.synchronize()
    sj = buf.shape[2] * j
    for got, want in ((r_mats, want_r), (r_cross, want_c)):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        finite = ~torch.isnan(want)
        assert _rel(got[finite], want[finite]) <= 1e-4
    assert torch.isnan(r_mats).sum() == 2 * (2 * sj - 1)
    assert torch.isnan(r_cross[1, 3 * j]).all() and torch.isnan(r_cross[2, 2 * j - 1]).all()
    assert torch.isnan(r_cross).sum() == 2 * 2


def test_jacobi_card_bound(dev):
    """The card serves up to 512 padded slots and names its bound past it."""
    with pytest.raises(ValueError, match="512"):
        K.jacobi_eigh(torch.zeros(1, 513, 513, device=dev), 1)
    with pytest.raises(ValueError, match="512"):
        K.jacobi_eigh_hermitian(torch.zeros(1, 257, 257, dtype=torch.complex64, device=dev), 1)


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
