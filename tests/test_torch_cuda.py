"""The port on a CUDA device: each kernel wrapper against its plain version
at ragged shapes, its launch count, its input checks on the card; K1 and
K6 (3xTF32 on the tensor cores) against a float64 oracle, on views with a
storage offset, and K6's exact symmetry and repeatability; K3 (both
forms), K5 and K11 against a float64 oracle, K3's exact zero and half
lanes, their NaN patterns, repeatability and width limits; and the hop on
the card (exact, production and 'invert' solver, the dense
statistics with K6, the truncated weighting with K8, and the
frequency-domain engine with K7) against the same hop on the CPU; K9 and
K10a against a float64 oracle, their repeatability and NaN propagation;
and the hop captured as a CUDA graph (engine/graph.py): each graphed
configuration against the eager hop, replays bit for bit, launch counts
under replay, graph=True refused where the hop reads the device mid-hop,
K2, K9 and K10b captured alone, and the serving drain against the hop
loop; checkpoint resume under the graph (the bfloat16 carry included),
the MATLAB configuration against the CPU, the bfloat16 carry graphed
against eager, and the offline VAST sweep in float64 against the CPU;
the hop meter (observability.py) on the card: its timed marks in a twin
of each branch graph, the twin against the graph without marks bit for
bit, the sections against the replay they time, no sync added, and
``trace``'s ``launch`` span around ``cudaGraphLaunch``.

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
loudspeaker feeds 5e-2 of each hop's scale; the cold first hop's feeds
against the CPU hop with exact statistics kernels, within the larger of
max(5e-2, 4 x the CPU hop's own spread under 1e-7 input changes) and 2 x
the CPU float32 hop's own distance from it), the
production hop compared hop by hop from the card's state
(tests/test_torch_tracking.py says why); K9 and K10a against float64
within twice the plain float32 version's own error.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from apvast_torch import ApVast, ApVastFD, GevdSolver, production_overrides
from apvast_torch.engine import hop as HOP
from apvast_torch.engine import hop_statistics, process_hop, process_hop_fd
from apvast_torch.engine.graph import clone_state
from apvast_torch.ops import kernels as K
from apvast_torch.ops import lag_statistics as LS
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
        # The production shape (n = 2k = 128), padded widths (20 -> 32 with
        # k = 8 -> 32; 44 -> 64 with k = 22 -> 32) and n > 2k.
        "tracked_rr": [(_spd(rnd, 2, 128), _spd(rnd, 2, 128), 64),
                       (_spd(rnd, 3, 20), _spd(rnd, 3, 20), 8),
                       (_spd(rnd, 1, 44), _spd(rnd, 1, 44), 22),
                       (_spd(rnd, 2, 100), _spd(rnd, 2, 100), 30)],
        "tracked_rr_coords": [
            (torch.tril(rnd(2, 128, 128)).contiguous(), rnd(2, 128, 64), rnd(2, 64),
             rnd(2, 64, 64)),
            (torch.tril(rnd(3, 20, 20)).contiguous(), rnd(3, 20, 7), rnd(3, 7), rnd(3, 7, 7)),
            (torch.tril(rnd(1, 5, 5)).contiguous(), rnd(1, 5, 3), rnd(1, 3), rnd(1, 3, 3)),
        ],
        # One panel, the padding path, the main path's shape; the most panels
        # (the longest look-ahead chain) and an odd batch.
        "chol_tri_inverse": [(_spd(rnd, 2, 128),), (_spd(rnd, 1, 200),), (_spd(rnd, 2, 800),),
                             (_spd(rnd, 1, 1024),), (_spd(rnd, 3, 300),)],
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
    "tracked_rr": K.tracked_rr_plain,
    "tracked_rr_coords": K.tracked_rr_coords_plain,
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


@pytest.mark.parametrize("n,bad", [(300, 150), (800, 300), (800, 700)],
                         ids=["panel1", "panel2-second-sub-panel", "last-panel"])
def test_chol_tri_inverse_non_pd_is_non_finite(dev, n, bad):
    """K10b: a negative pivot gives non-finite rows from its sub-panel down
    (and, past the first panel, in the columns before its panel of the
    panel's rows above it, as the plain version's refinement spreads it),
    the non-finite entries of the lower triangle are the plain version's,
    the SPD matrix beside it stays finite, and both keep exact zeros above
    the diagonal."""
    g = torch.Generator().manual_seed(4)
    b = _spd(lambda *s: torch.randn(s, generator=g).to(dev), 2, n)
    b[1, bad, bad] = -1.0
    x = K.chol_tri_inverse(b)
    want = K.chol_tri_inverse_plain(b)
    torch.cuda.synchronize()
    assert torch.isfinite(x[0]).all() and not torch.isfinite(x[1]).all()
    assert torch.isfinite(x[1, : bad // 128 * 128]).all()
    r0 = bad // 32 * 32
    rows_lower = torch.ones(n - r0, n, dtype=torch.bool, device=dev).tril(r0)
    assert not torch.isfinite(x[1, r0:])[rows_lower].any()
    lower = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    assert torch.equal(torch.isfinite(x[1])[lower], torch.isfinite(want[1])[lower])
    assert (torch.triu(x, 1) == 0).all()


# K10b against its plain version (the JAX package's bound, chip_smoke.py's
# TOL_CHOL_TRI) and a float64 oracle at each shape of _cases.
TOL_CHOL_TRI = 1e-5


# (9, 256): more matrices than one launch takes (7 on a 132-SM card).
@pytest.mark.parametrize("bz,n", [(2, 128), (1, 200), (2, 800), (1, 1024), (3, 300), (9, 256)])
def test_chol_tri_inverse_within_1e5_of_plain_and_float64(dev, bz, n):
    g = torch.Generator().manual_seed(n + bz)
    b = _spd(lambda *s: torch.randn(s, generator=g).to(dev), bz, n)
    x = K.chol_tri_inverse(b)
    torch.cuda.synchronize()
    assert _rel(x, K.chol_tri_inverse_plain(b)) <= TOL_CHOL_TRI
    eye = torch.eye(n, dtype=torch.float64, device=dev).expand(bz, n, n)
    oracle = torch.linalg.solve_triangular(torch.linalg.cholesky(b.double()), eye, upper=False)
    assert _rel(x, oracle) <= TOL_CHOL_TRI
    assert (torch.triu(x, 1) == 0).all()


def test_chol_tri_inverse_repeats_bit_for_bit(dev):
    """Three launches with other work on the stream between them: the
    ready counters are zeroed inside each launch, and each tile's sums keep
    their order whatever block takes the tile."""
    g = torch.Generator().manual_seed(12)
    b = _spd(lambda *s: torch.randn(s, generator=g).to(dev), 2, 800)
    other = torch.randn(2, 4096, 4096, generator=g).to(dev)
    runs = []
    for _ in range(3):
        runs.append(K.chol_tri_inverse(b))
        other = other @ other.transpose(1, 2) / 4096
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_chol_tri_inverse_ill_conditioned_residual(dev):
    """The whitening residual max |X B X^T - I| of a 1e5 rank-one boost
    within twice that of cholesky_ex + solve_triangular, plus 1e-5."""
    g = torch.Generator().manual_seed(13)
    x0 = torch.randn(2, 800, 800, generator=g)
    b = x0 @ x0.transpose(1, 2) / 800 + torch.eye(800)
    b[0] += 1e5 * torch.outer(x0[0, 0], x0[0, 0]) / 800
    b = b.to(dev).contiguous()
    eye = torch.eye(800, device=dev)
    x = K.chol_tri_inverse(b)
    chain = torch.linalg.solve_triangular(torch.linalg.cholesky_ex(b)[0], eye.expand(2, 800, 800),
                                          upper=False)

    def residual(m):
        m = m.double()
        return float((m @ b.double() @ m.transpose(1, 2) - eye.double()).abs().max())

    assert residual(x) <= 2.0 * residual(chain) + 1e-5


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


# K9 and K10a against a float64 oracle (their plain versions in float64 on
# the card): within TOL_ORACLE_RATIO x the plain float32 version's own error.
TOL_ORACLE_RATIO = 2.0
# K9: (bz, n, k, iters) of the north star, ragged and the widest width.
_K9_CASES = {
    "north star": (2, 800, 64, 2),
    "(3, 50, 8) iters 1": (3, 50, 8, 1),
    "(1, 40, 16) iters 0": (1, 40, 16, 0),
    "(2, 200, 24)": (2, 200, 24, 2),
    "k 112": (2, 200, 112, 2),
}


def _k9_inputs(dev, case, seed):
    """a SPD, li the inverse Cholesky factor of an SPD matrix (its lower
    triangle: the kernel reads no other), q0 random."""
    bz, n, k, iters = _K9_CASES[case]
    g = torch.Generator().manual_seed(seed)
    a, li, q0, _ = _subspace_args(lambda *sh: torch.randn(sh, generator=g).to(dev), bz, n, k, 0)
    return a, torch.tril(li).contiguous(), q0, iters


def _panels(dev, bz, seed):
    g = torch.Generator().manual_seed(seed)
    return _spd(lambda *sh: torch.randn(sh, generator=g).to(dev), bz, 128)


@pytest.mark.parametrize("case", list(_K9_CASES))
def test_subspace_within_twice_plain_error_against_float64(dev, case):
    a, li, q0, iters = _k9_inputs(dev, case, 61)
    got = K.subspace_iterate(a, li, q0, iters)
    want = K.subspace_iterate_plain(a, li, q0, iters)
    oracle = K.subspace_iterate_plain(a.double(), li.double(), q0.double(), iters)
    torch.cuda.synchronize()
    for x, w, o in zip(got, want, oracle):
        assert _rel(x, w) <= 1e-4
        assert _rel(x, o) <= TOL_ORACLE_RATIO * _rel(w, o), (_rel(x, o), _rel(w, o))


@pytest.mark.parametrize("bz", [1, 2, 3])
def test_whiten_within_twice_plain_error_against_float64(dev, bz):
    d = _panels(dev, bz, 63 + bz)
    got, want = K.chol_panel(d), K.chol_panel_plain(d)
    oracle = K.chol_panel_plain(d.double())
    torch.cuda.synchronize()
    for x, w, o in zip(got, want, oracle):
        assert _rel(x, w) <= 1e-4
        assert _rel(x, o) <= TOL_ORACLE_RATIO * _rel(w, o), (_rel(x, o), _rel(w, o))
        assert torch.equal(torch.triu(x, 1), torch.zeros_like(x))


def test_subspace_and_whiten_repeat_bit_for_bit(dev):
    """Two launches on the same inputs give the same bits: the Gram partials
    and the warp groups' sums are added in a fixed order, no atomics."""
    a, li, q0, iters = _k9_inputs(dev, "north star", 65)
    d = _panels(dev, 2, 66)
    first = K.subspace_iterate(a, li, q0, iters) + K.chol_panel(d)
    second = K.subspace_iterate(a, li, q0, iters) + K.chol_panel(d)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("iters", [0, 2])
def test_subspace_propagates_nan_as_plain(dev, iters):
    """A NaN in one pencil's warm start: the plain version's NaN pattern
    (pencil 1's q and small wholly, with iterations; at iters = 0 the
    NaN's column of q and its row and column of small), pencil 0 finite."""
    a, li, q0, _ = _k9_inputs(dev, "(2, 200, 24)", 67)
    q0[1, 37, 5] = float("nan")
    got = K.subspace_iterate(a, li, q0, iters)
    want = K.subspace_iterate_plain(a, li, q0, iters)
    torch.cuda.synchronize()
    for x, w in zip(got, want):
        assert torch.equal(torch.isnan(x), torch.isnan(w))
        assert torch.isnan(x[1]).any() and torch.isfinite(x[0]).all()
        finite = ~torch.isnan(w)
        assert _rel(x[finite], w[finite]) <= 1e-4


def test_whiten_propagates_nan_as_plain(dev):
    """A NaN below the diagonal of one panel: L's and X's NaN patterns are
    the plain version's (the column algorithms' pattern), the panels beside
    it finite."""
    d = _panels(dev, 3, 68)
    d[2, 90, 20] = float("nan")
    got, want = K.chol_panel(d), K.chol_panel_plain(d)
    torch.cuda.synchronize()
    for x, w in zip(got, want):
        assert torch.equal(torch.isnan(x), torch.isnan(w))
        assert torch.isfinite(x[:2]).all() and torch.isnan(x[2]).any()
        finite = ~torch.isnan(w)
        assert _rel(x[finite], w[finite]) <= 1e-4


# K2 at the north star and at the ragged shapes of chip_smoke.py's phase 2.
_K2_CASES = {
    "north star": ((4, 17, 17, 999), 50),
    "(4, 3, 5, 70) J 9": ((4, 3, 5, 70), 9),
    "(4, 2, 33, 120) J 40": ((4, 2, 33, 120), 40),
}


def _k2_inputs(dev, case, seed):
    shape, j = _K2_CASES[case]
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev), j


@pytest.mark.parametrize("case", list(_K2_CASES))
def test_lag_corr_within_twice_plain_error_against_float64(dev, case):
    """K2 against a float64 oracle (its plain version in float64 on the
    card): within 2x the plain float32 version's own error, and within
    1e-4 of the plain version's scale."""
    x, j = _k2_inputs(dev, case, 71)
    got, want = K.lag_corr(x, j), K.lag_corr_plain(x, j)
    oracle = K.lag_corr_plain(x.double(), j)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-4
    assert _rel(got, oracle) <= TOL_ORACLE_RATIO * _rel(want, oracle), (
        _rel(got, oracle), _rel(want, oracle))


def test_lag_corr_repeats_bit_for_bit(dev):
    """Two launches on the same inputs give the same bits: the depth
    slices' partials are added in slice order, no atomics."""
    x, j = _k2_inputs(dev, "north star", 73)
    first, second = K.lag_corr(x, j), K.lag_corr(x, j)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_lag_corr_propagates_nan_as_plain(dev):
    """A NaN past K in an s2 row reaches only the lags whose window holds
    it (lags l > t - K of that s2, every s1); a NaN in the all-zero target
    row of a dark path reaches that row's and that column's outputs (0 x
    NaN stays NaN: the zero row is not skipped). The plain version's NaN
    pattern, and its values elsewhere."""
    x, j = _k2_inputs(dev, "north star", 79)
    _, _, s, n = x.shape
    k = n - j + 1
    x[0, 3, 5, k + 20] = float("nan")  # lags 21-49 of s2 = 5
    x[1, :, s - 1] = 0.0  # a dark path's target row
    x[1, 7, s - 1, 100] = float("nan")
    got, want = K.lag_corr(x, j), K.lag_corr_plain(x, j)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got[0]).sum()) == s * (j - 21)
    assert int(torch.isnan(got[1]).sum()) == 2 * s * j - j
    assert not torch.isnan(got[2:]).any()
    finite = ~torch.isnan(want)
    assert _rel(got[finite], want[finite]) <= 1e-4


# K3 at the north star, at scale_scene(32)'s shapes, at J = 100
# (reference_scene()) and at two ragged shapes (source groups that do not
# divide S): (S, J, C).
_K3_CASES = {
    "north star": (16, 50, 34),
    "32 sources": (32, 50, 66),
    "J 100": (8, 100, 18),
    "S5 J9 C6": (5, 9, 6),
    "S33 J3 C4": (33, 3, 4),
}


def _k3_inputs(dev, case, seed):
    s, j, c = _K3_CASES[case]
    g = torch.Generator().manual_seed(seed)
    lhs = torch.randn((4, j * s, c), generator=g)
    lhs[:, :s] = 0.0  # row a = 0 of the edge factors is zero by construction
    rhs, c0 = torch.randn((4, c, s * j), generator=g), torch.randn((4, s, s * j), generator=g)
    return lhs.to(dev), rhs.to(dev), c0.to(dev), j


@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("case", list(_K3_CASES))
def test_skew_assembly_within_twice_plain_error_against_float64(dev, case, half):
    """K3 against a float64 oracle (its plain version in float64 on the
    card): within 2x the plain float32 version's own error, and within
    1e-4 of the plain version's scale."""
    lhs, rhs, c0, j = _k3_inputs(dev, case, 91)
    got = K.lag_skew_assemble(lhs, rhs, c0, j, half)
    want = K.lag_skew_assemble_plain(lhs, rhs, c0, j, half)
    oracle = K.lag_skew_assemble_plain(lhs.double(), rhs.double(), c0.double(), j, half)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-4
    assert _rel(got, oracle) <= TOL_ORACLE_RATIO * _rel(want, oracle), (
        _rel(got, oracle), _rel(want, oracle))


@pytest.mark.parametrize("case", ["north star", "S5 J9 C6"])
def test_skew_assembly_zero_and_half_lanes_exact(dev, case):
    """The strict-upper-tap lanes are exactly 0 in both forms; the half
    form's tap-diagonal lanes are exactly half the full form's and its
    other lanes equal it bit for bit (the same sums, an exact scaling)."""
    lhs, rhs, c0, j = _k3_inputs(dev, case, 93)
    full, half = K.lag_skew_assemble(lhs, rhs, c0, j), K.lag_skew_assemble(lhs, rhs, c0, j, True)
    torch.cuda.synchronize()
    t2 = torch.arange(full.shape[-1], device=dev) % j
    t1 = torch.arange(j, device=dev)
    upper = (t2[None, :] > t1[:, None]).expand_as(full)
    diag = (t2[None, :] == t1[:, None]).expand_as(full)
    assert not full[upper].any() and not half[upper].any()
    assert torch.equal(half[diag], 0.5 * full[diag])
    assert torch.equal(half[~diag], full[~diag])


def test_skew_assembly_and_output_filter_repeat_bit_for_bit(dev):
    """Two launches on the same inputs give the same bits (fixed orders,
    no atomics)."""
    lhs, rhs, c0, j = _k3_inputs(dev, "north star", 95)
    k5 = _k5_inputs(dev, "north star", 96)
    first = (K.lag_skew_assemble(lhs, rhs, c0, j, True), *K.circular_filter_overlap(*k5))
    second = (K.lag_skew_assemble(lhs, rhs, c0, j, True), *K.circular_filter_overlap(*k5))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("where", ["lhs_t", "rhs"])
def test_skew_assembly_propagates_nan_as_plain(dev, where):
    """One NaN in an lhs row (source s1 = 3, tap band a = 7) reaches the
    rows of that s1 from band 7 on; one in an rhs column reaches the lanes
    whose diagonal sums hold it, for every s1. The plain version's NaN
    pattern in both forms (the strict-upper-tap lanes stay 0), its values
    elsewhere."""
    lhs, rhs, c0, j = _k3_inputs(dev, "north star", 97)
    s = c0.shape[1]
    if where == "lhs_t":
        lhs[1, 7 * s + 3, 5] = float("nan")
    else:
        rhs[2, 11, 3 * j + 20] = float("nan")
    for half in (False, True):
        got = K.lag_skew_assemble(lhs, rhs, c0, j, half)
        want = K.lag_skew_assemble_plain(lhs, rhs, c0, j, half)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.isnan(got).any()
        finite = ~torch.isnan(want)
        assert _rel(got[finite], want[finite]) <= 1e-4


def test_skew_assembly_card_bound(dev):
    """Past 227 KB of shared memory for a 4-row band the wrapper names the
    limit (the CPU serves the shape)."""
    s, j, c = 1, 2000, 30
    args = (torch.zeros(1, j * s, c), torch.zeros(1, c, s * j), torch.zeros(1, s, s * j))
    assert K.lag_skew_assemble(*args, j).shape == (1, s, j, s * j)
    with pytest.raises(ValueError, match="227 KB"):
        K.lag_skew_assemble(*(a.to(dev) for a in args), j)


# K5 at the north star, at scale_scene(32)'s rows, at J = 100
# (reference_scene(): 400 rows) and at two ragged shapes, hop below and
# above block - hop: (block, rows, taps, hop).
_K5_CASES = {
    "north star": (1600, 800, 50, 800),
    "32 sources": (1600, 1600, 50, 800),
    "J 100": (1600, 400, 100, 800),
    "(2, 37, 9) hop 30": (100, 37, 9, 30),
    "(2, 37, 9) hop 60": (100, 37, 9, 60),
}


def _k5_inputs(dev, case, seed):
    block, rows, taps, hop = _K5_CASES[case]
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((2, block), generator=g).to(dev),
            (1e-2 * torch.randn((2, rows, taps), generator=g)).to(dev),
            torch.rand(block, generator=g).to(dev),
            (1e-2 * torch.randn((2, rows, block - hop), generator=g)).to(dev), hop)


@pytest.mark.parametrize("case", list(_K5_CASES))
def test_output_filter_within_twice_plain_error_against_float64(dev, case):
    """K5 (emit and new tail) and K11 against a float64 oracle: within 2x
    the plain float32 version's own error, and within 1e-4 of its scale."""
    x, f, w, t, hop = _k5_inputs(dev, case, 99)
    runs = [(K.circular_filter_overlap(x, f, w, t, hop),
             K.circular_filter_overlap_plain(x, f, w, t, hop),
             K.circular_filter_overlap_plain(x.double(), f.double(), w.double(), t.double(), hop)),
            ((K.circular_filter(x, f),), (K.circular_filter_plain(x, f),),
             (K.circular_filter_plain(x.double(), f.double()),))]
    torch.cuda.synchronize()
    for got, want, oracle in runs:
        for g_, w_, o_ in zip(got, want, oracle):
            assert _rel(g_, w_) <= 1e-4
            assert _rel(g_, o_) <= TOL_ORACLE_RATIO * _rel(w_, o_), (_rel(g_, o_), _rel(w_, o_))


def test_output_filter_propagates_nan_as_plain(dev):
    """One NaN in the tail reaches only its own output (emit, below hop, in
    the north star's hop = block - hop), as in the plain version."""
    x, f, w, t, hop = _k5_inputs(dev, "north star", 101)
    t[1, 300, 17] = float("nan")
    got = K.circular_filter_overlap(x, f, w, t, hop)
    want = K.circular_filter_overlap_plain(x, f, w, t, hop)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert torch.equal(torch.isnan(g_), torch.isnan(w_))
        finite = ~torch.isnan(w_)
        assert _rel(g_[finite], w_[finite]) <= 1e-4
    assert torch.isnan(got[0][1, 300, 17]) and int(torch.isnan(got[0]).sum()) == 1
    assert not torch.isnan(got[1]).any()


def test_output_filter_card_bound(dev):
    """Past 1632 taps (K5) and 1756 (K11) the filter rows outgrow a block's
    shared memory and the wrappers name the limit."""
    block = 1760
    x, w = torch.zeros(1, block, device=dev), torch.zeros(block, device=dev)
    f5, f11 = torch.zeros(1, 1, 1633, device=dev), torch.zeros(1, 1, 1757, device=dev)
    with pytest.raises(ValueError, match="1632"):
        K.circular_filter_overlap(x, f5, w, torch.zeros(1, 1, block - 800, device=dev), 800)
    with pytest.raises(ValueError, match="1756"):
        K.circular_filter(x, f11)


@pytest.mark.parametrize("sweeps", [2, 3, 8])
@pytest.mark.parametrize("n", [10, 37, 64], ids=["16-slots", "40-slots", "64-slots"])
def test_jacobi_pair_form_equals_template_bit_for_bit(dev, n, sweeps):
    """K4's pair-block form (the wrapper's form up to 64 slots) runs the
    template form's rotations in the same order with the same products:
    w and v equal bit for bit, on a warm-start-like and a cold matrix."""
    from apvast_torch.ops.kernels.jacobi_eigh import jacobi_eigh_template

    g = torch.Generator().manual_seed(83 + n)
    rnd = lambda *sh: torch.randn(sh, generator=g).to(dev)  # noqa: E731
    cold = rnd(1, n, n)
    a = torch.cat([_warm(rnd, 1, n), (cold + cold.transpose(1, 2)) / 2]).contiguous()
    before = K.jacobi_eigh.launches
    pair, template = K.jacobi_eigh(a, sweeps), jacobi_eigh_template(a, sweeps)
    torch.cuda.synchronize()
    assert K.jacobi_eigh.launches == before + 2
    assert torch.equal(pair[0], template[0]) and torch.equal(pair[1], template[1])


def test_jacobi_pair_form_propagates_nan_as_plain(dev):
    """A NaN entry of one matrix spreads through its rotations: as in the
    plain version's one-hot contraction (0 x NaN is NaN), all of its w and
    v are NaN; the matrices beside it are finite and equal the plain
    version."""
    g = torch.Generator().manual_seed(89)
    a = _warm(lambda *sh: torch.randn(sh, generator=g).to(dev), 3, 64).contiguous()
    a[1, 5, 9] = float("nan")
    got, want = K.jacobi_eigh(a, 2), K.jacobi_eigh_plain(a, 2)
    torch.cuda.synchronize()
    for x, w in zip(got, want):
        assert torch.equal(torch.isnan(x), torch.isnan(w))
        assert torch.isnan(x[1]).all() and torch.isfinite(x[[0, 2]]).all()
        assert _rel(x[[0, 2]], w[[0, 2]]) <= 1e-4


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


@pytest.mark.parametrize("form", ["full", "half"])
def test_skew_statistics_refuse_float64_on_the_card(dev, form):
    """Float64 skew statistics run K3's plain version on the CPU only: on
    the card K3 (and K2) take float32, and float64 raises."""
    j, n = 5, 40
    buf = torch.zeros(4, 2, 3, n, dtype=torch.float64, device=dev)
    d = torch.zeros(2, 2, n - j + 1, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        K.lag_skew_assemble(*(torch.zeros(*s, dtype=torch.float64, device=dev)
                              for s in ((4, 15, 4), (4, 4, 15), (4, 3, 15))), j)
    with pytest.raises(ValueError, match="float32"):
        LS.covariance_via_lags_skew(buf, d, j, form=form)
    for c0_method in ("pallas", "auto"):
        with pytest.raises(ValueError, match="float32"):
            LS.covariance_via_lags_skew(buf, d, j, form=form, c0_method=c0_method)


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


# The cold first hop's loudspeaker feeds are held to max(5e-2,
# COLD_SPREAD_FACTOR x the CPU hop's own spread): the largest deviation,
# over COLD_SPREAD_SEEDS, of the CPU's first-hop feeds under 1e-7 relative
# changes of response_noise, relative to that hop's own scale (computed as
# tools/cold_hop_rounding.py computes it). 4 is chip_smoke.py's
# FD_SPREAD_FACTOR, which holds fd-jacobi's feeds to the CPU hop's spread.
COLD_SPREAD_FACTOR = 4.0
COLD_SPREAD_SEEDS = (101, 102, 103)


def _cold_hop_spread(overrides):
    def first_hop(seed=None):
        rng = np.random.default_rng(10)
        kwargs = _s8_kwargs(rng, production_overrides() | overrides)
        if seed is not None:
            jr = np.random.default_rng(seed)
            kwargs["response_noise"] = tuple(
                x * (1 + 1e-7 * jr.standard_normal(x.shape)) for x in kwargs["response_noise"])
        a, b = rng.standard_normal((8, 2, 64)).astype(np.float32)[0]
        return ApVast(device="cpu", **kwargs).process_input_buffers(a, b)[:2]

    base = first_hop()
    return max(_rel(x, y) for seed in COLD_SPREAD_SEEDS for x, y in zip(first_hop(seed), base))


# The statistics kernels the hop calls (K1, K6 in engine/hop.py; K2, K3 in
# ops/lag_statistics.py), by module and name, and their exact forms: the
# plain version in float64, rounded once to float32.
_STATISTICS_KERNELS = {
    "streaming_conv": (HOP, lambda s, k, h: K.streaming_conv_plain(s.double(), k.double(), h)),
    "covariance": (HOP, lambda b, t, j: K.covariance_plain(b.double(), t.double(), j)),
    "lag_corr": (LS, lambda x, j: K.lag_corr_plain(x.double(), j)),
    "lag_skew_assemble": (LS, lambda lhs, rhs, c0, j, half_scaled=False: (
        K.lag_skew_assemble_plain(lhs.double(), rhs.double(), c0.double(), j, half_scaled))),
}


def _rounded(fn):
    def exact(*args, **kwargs):
        out = fn(*args, **kwargs)
        return tuple(x.float() for x in out) if isinstance(out, tuple) else out.float()
    return exact


EXACT_KERNELS = {name: _rounded(fn) for name, (_, fn) in _STATISTICS_KERNELS.items()}


@contextlib.contextmanager
def statistics_kernels(forms):
    """The hop with ``forms`` (name -> function, names of
    _STATISTICS_KERNELS) in place of those statistics kernels."""
    shipped = {name: getattr(_STATISTICS_KERNELS[name][0], name) for name in forms}
    try:
        for name, fn in forms.items():
            setattr(_STATISTICS_KERNELS[name][0], name, fn)
        yield
    finally:
        for name, fn in shipped.items():
            setattr(_STATISTICS_KERNELS[name][0], name, fn)


def exact_hop(config, plan, state, a, b):
    """The CPU hop from ``state`` with every statistics kernel that the
    configuration launches computed exactly (EXACT_KERNELS): the first
    hop's float64 reference (tools/cold_hop_rounding.py reads it too)."""
    with statistics_kernels(EXACT_KERNELS):
        return process_hop(config, plan, state, torch.from_numpy(a), torch.from_numpy(b))[1]


# K4 at 8 sweeps: at the round-3 solvers' 2-3 sweeps it is unconverged on
# their Rayleigh-Ritz matrices, and card and CPU then part by rounding
# (chip_smoke.py, CONVERGED_SWEEPS).
_INVERT = {"subspace_whiten": "invert", "jacobi_sweeps": 8, "subspace_oversample": 8,
           "use_pallas_subspace": True, "use_pallas_whiten": True}


_PRODUCTION_KERNELS = ("streaming_conv", "lag_corr", "skew_assembly", "jacobi_eigh",
                       "output_filter")
# The tracking solver's Rayleigh-Ritz solve and coordinates around K4 (not
# the round-3 solvers').
_TRACKER_KERNELS = ("tracked_rr", "tracked_rr_coords")
# Each configuration's overrides of production_overrides() and the kernels
# its hop launches once.
_CARD_PATHS = {
    "production": ({}, _PRODUCTION_KERNELS + _TRACKER_KERNELS),
    "invert": (_INVERT, _PRODUCTION_KERNELS + ("whiten", "subspace")),
    "dense": ({"use_lag_statistics": False},
              ("streaming_conv", "statistics", "jacobi_eigh", "output_filter")
              + _TRACKER_KERNELS),
    "weighting-conv": ({"weighting_conv_taps": 31},
                       _PRODUCTION_KERNELS + _TRACKER_KERNELS + ("rowwise_conv",)),
}


@pytest.mark.parametrize("config", list(_CARD_PATHS))
def test_production_hop_on_the_card_matches_cpu(dev, config):
    """The production configuration launches its five kernels every hop,
    the 'invert' one (k = 16, JL = 96: one panel) all seven, the dense one
    K6 in place of K2 and K3, the truncated weighting K8 besides the five;
    each card hop equals the CPU hop from the same state. The cold first
    hop's loudspeaker feeds are held, as every kernel is, against a float64
    reference: the CPU hop with exact statistics kernels (exact_hop), within
    max(cold_bar, TOL_ORACLE_RATIO x d), d the CPU float32 hop's own
    distance from that reference."""
    rng = np.random.default_rng(10)
    overrides, kernels = _CARD_PATHS[config]
    kwargs = _s8_kwargs(rng, production_overrides() | overrides)
    cold_bar = max(5e-2, COLD_SPREAD_FACTOR * _cold_hop_spread(overrides))
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
        # noise: rounding alone moves its feeds on the CPU by the spread
        # that cold_bar scales (tools/cold_hop_rounding.py); for 'invert'
        # also through the ill-conditioned dark matrix's float32 inverse
        # factor, by more than that spread. So hop 1 is held against the
        # float64 reference. The later hops are held to 5e-2.
        if hop == 0:
            ref = exact_hop(cpu.config, cpu.plan, start, a, b)
            d = max(_rel(getattr(want, name), getattr(ref, name)) for name in ("out_a", "out_b"))
            bar = max(cold_bar, TOL_ORACLE_RATIO * d)
        for f, name in enumerate(("out_a", "out_b", "out_a_t", "out_b_t")):
            w = getattr(want, name)
            assert torch.isfinite(got[f]).all()
            if name.endswith("_t"):
                assert _rel(got[f], w) <= 1e-5, name
            elif hop == 0:
                assert _rel(got[f], getattr(ref, name)) <= bar, (name, d, bar)
            else:
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


# ---- the graphed hop (engine/graph.py) -------------------------------------

# Each graphed configuration's overrides: the time-domain ones of
# production_overrides() on the S = 8 scene, the FD ones on the FD scene.
_GRAPHED_TD = {
    "production": {},
    "invert": _INVERT,
    "solve": {"subspace_whiten": "solve"},
    "dense": {"use_lag_statistics": False},
    "weighting-conv": {"weighting_conv_taps": 31},
    "matmul-wola": {"use_matmul_dft": True},
}
_GRAPHED_FD = {
    "fd-jacobi": {"fd_eigh": "jacobi"},
    "fd-full": {"fd_span": "full"},
    "fd-coupled": {"fd_span": "full", "fd_bin_coupling": 7, "fd_frame_taps": 2,
                   "number_of_eigenvectors": 8},
    "fd-cg": {"fd_span": "full", "fd_coupled_iters": 4, "fd_coupled_method": "cg"},
}


def _fd_kwargs(rng, overrides):
    noise = (1e-3 * rng.standard_normal((4, 3, 4, 128)), 1e-3 * rng.standard_normal((2, 3, 128)))
    return dict(
        block_size=128, rir_a=synthetic_rirs(120, 4, 3, seed=1),
        rir_b=synthetic_rirs(120, 4, 3, seed=2), filter_length=16, modeling_delay=5,
        reference_index_a=1, reference_index_b=2, number_of_eigenvectors=4, mu=1.0,
        sampling_rate=8000, perceptual=True, response_noise=noise, dtype="float32",
        use_matmul_dft=True, use_pallas_conv=True, forgetting=0.97,
    ) | overrides


def _graphed_pair(dev, config, seed=13):
    """A graphed and an eager model of one configuration, one initial state."""
    rng = np.random.default_rng(seed)
    if config in _GRAPHED_FD:
        kwargs = _fd_kwargs(rng, _GRAPHED_FD[config])
        build = ApVastFD
    else:
        kwargs = _s8_kwargs(rng, production_overrides() | _GRAPHED_TD[config])
        build = ApVast
    return build(device=dev, **kwargs), build(device=dev, graph=False, **kwargs), rng


def _statistics(model):
    if isinstance(model, ApVastFD):
        return model.state.cov, model.state.cross
    return hop_statistics(model.config, model.state.wresp_stat, model.state.wtarget_stat)


@pytest.mark.parametrize("config", [*_GRAPHED_TD, *_GRAPHED_FD])
def test_graphed_hop_equals_eager_on_the_card(dev, config):
    """Each graphed configuration against the eager hop (graph=False), hop by
    hop from one state: statistics and target feeds within 1e-5 of their
    scale, loudspeaker feeds within 5e-2, the same launch counts, rebuild
    decisions and silenced == 0."""
    graphed, eager, rng = _graphed_pair(dev, config)
    assert graphed.graphed and graphed.graph is not None and not eager.graphed
    for hop in range(8):
        eager.state = clone_state(graphed.state)
        a, b = rng.standard_normal((2, graphed.config.hop)).astype(np.float32)
        K.reset_launch_counts()
        got = graphed.process_input_buffers(a, b)
        counts = K.launch_counts()
        K.reset_launch_counts()
        want = eager.process_input_buffers(a, b)
        assert counts == K.launch_counts() and sum(counts.values()) > 0, hop
        for x, y in zip(_statistics(graphed), _statistics(eager)):
            assert _rel(x, y) <= 1e-5, hop
        for f in range(4):
            if want[f] is None:
                continue
            assert torch.isfinite(got[f]).all()
            assert _rel(got[f], want[f]) <= (1e-5 if f >= 2 else 5e-2), (hop, f)
    assert graphed.rebuilds == eager.rebuilds
    assert int(graphed.silenced) == 0 and int(eager.silenced) == 0


@pytest.mark.parametrize("rebuilt", [False, True], ids=["no-rebuild", "rebuild"])
def test_graph_replays_bit_for_bit(dev, rebuilt):
    """One branch replayed three times from one saved state, other work on
    the stream between the replays: outputs and state bit for bit."""
    graphed, _, rng = _graphed_pair(dev, "production")
    for _ in range(7):  # past the warmup
        graphed.process_input_buffers(*rng.standard_normal((2, 64)).astype(np.float32))
    saved = clone_state(graphed.state)
    a, b = (torch.from_numpy(x).to(dev) for x in rng.standard_normal((2, 64)).astype(np.float32))
    runs = []
    for _ in range(3):
        graphed.state = saved
        x = torch.randn(512, 512, device=dev)
        (x @ x).sum()
        graphed.graph.stage(a, b)
        out = graphed.graph.replay(rebuilt)
        runs.append(([out.out_a.clone(), out.out_b.clone(), out.out_a_t.clone()],
                     clone_state(graphed.state)))
    torch.cuda.synchronize()
    for outs, state in runs[1:]:
        for x, y in zip(outs, runs[0][0]):
            assert torch.equal(x, y)
        for f in dataclasses.fields(state):
            x, y = getattr(state, f.name), getattr(runs[0][1], f.name)
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, f.name


def test_launch_counts_under_replay(dev):
    """Capture (warmup included) adds no launch; every replay adds its
    graph's capture counts, so a graphed run counts what an eager one does."""
    K.reset_launch_counts()
    graphed, _, rng = _graphed_pair(dev, "invert")
    assert sum(K.launch_counts().values()) == 0
    for _ in range(5):
        graphed.process_input_buffers(*rng.standard_normal((2, 64)).astype(np.float32))
    kernels = _PRODUCTION_KERNELS + ("whiten", "subspace")
    assert K.launch_counts() == {name: 5 if name in kernels else 0 for name in K.WRAPPERS}
    assert set(graphed.graph.graphs) == {False}
    production, _, _ = _graphed_pair(dev, "production")
    assert set(production.graph.graphs) == {False, True}


@pytest.mark.parametrize("overrides,reason", [
    ({"gevd_solver": GevdSolver.EIGH}, "eigh"),
    ({"subspace_whiten": "newton"}, "newton"),
], ids=["exact", "newton"])
def test_graph_true_raises_on_eager_only_configurations(dev, overrides, reason):
    kwargs = _s8_kwargs(np.random.default_rng(1), production_overrides() | overrides)
    with pytest.raises(ValueError, match=reason):
        ApVast(device=dev, graph=True, **kwargs)
    model = ApVast(device=dev, **kwargs)
    assert not model.graphed and reason in model.eager_reason and model.graph is None


def _capture(fn, *args):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    return graph, out


def _cooperative_args(dev, name, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=g).to(dev)

    return {
        "lag_corr": (rnd(4, 17, 17, 999), 50),  # the main path's shape: many depth slices
        "subspace": _subspace_args(rnd, 2, 800, 64, 2),
        "chol_tri_inverse": (_spd(rnd, 2, 800),),
    }[name]


@pytest.mark.parametrize("name", ["lag_corr", "subspace", "chol_tri_inverse"])
def test_cooperative_kernel_captured_alone(dev, name):
    """K2, K9 and K10b (cooperative launches with grid barriers or ready
    counters) captured alone: a replay equals the eager launch bit for bit,
    and after the inputs change in place the replay follows them."""
    fn = K.WRAPPERS[name]
    args = _cooperative_args(dev, name, 3)
    graph, out = _capture(fn, *args)
    out = out if isinstance(out, tuple) else (out,)
    for seed in (3, 4):
        fresh = _cooperative_args(dev, name, seed)
        for x, y in zip(args, fresh):
            if isinstance(x, torch.Tensor):
                x.copy_(y)
        graph.replay()
        want = fn(*fresh)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        for x, y in zip(out, want):
            assert torch.equal(x, y), (name, seed)


@pytest.mark.parametrize("pcm", [False, True])
def test_process_hops_span_equals_hop_loop_on_the_card(dev, pcm):
    """The serving drain on the graphed production hop: one upload, the
    replays, the span selection (and the int16 pack) on the card, one
    fetch; bit for bit the per-hop loop's feeds without pcm, within half
    a quantization step (and float32 rounding) with it."""
    drained, _, rng = _graphed_pair(dev, "production")
    stepped, _, _ = _graphed_pair(dev, "production")
    sig = rng.standard_normal((2, 64 * 9)).astype(np.float32)
    fa, fb = drained.process_hops_span(sig[0], sig[1], span_index=-1, pcm=pcm)
    want = [stepped.process_input_buffers(sig[0, i * 64 : (i + 1) * 64],
                                          sig[1, i * 64 : (i + 1) * 64]) for i in range(9)]
    assert drained.rebuilds == stepped.rebuilds
    for got, f in ((fa, 0), (fb, 1)):
        ref = torch.cat([w[f][-1] for w in want]).cpu().numpy()
        if pcm:  # half a step, and float32 rounding of the scale and the dequantization
            peak = max(np.abs(fa).max(), np.abs(fb).max())
            assert np.abs(got - ref).max() <= peak * (0.5 / 32766 + 4 * np.finfo(np.float32).eps)
        else:
            np.testing.assert_array_equal(got, ref)


# ---- multi-stream: the scene-batched hop (parallel/mesh.py) -----------------


def _multi_model(dev, config, n, graph=None, **extra):
    """``n`` S = 8 scenes of one graphed configuration in a MultiSceneApVast;
    scene i's RIRs from seeds 81 + 2i and 82 + 2i."""
    from apvast_torch import ApVastConfig, MultiSceneApVast

    pairs = [(synthetic_rirs(96, 8, 3, seed=81 + 2 * i), synthetic_rirs(96, 8, 3, seed=82 + 2 * i))
             for i in range(n)]
    cfg = ApVastConfig.for_rirs(
        *pairs[0], block_size=128, filter_length=12, modeling_delay=4, reference_index_a=0,
        reference_index_b=5, num_eigenvectors=8, mu=1.0, statistics_buffer_length=128,
        sampling_rate=8000, perceptual=True,
        **(production_overrides() | _GRAPHED_TD[config] | extra))
    return MultiSceneApVast(cfg, pairs, device=dev, graph=graph)


def _assert_same(got, want, where):
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(x, y) if isinstance(y, torch.Tensor) else x == y, (where, f.name)


@pytest.mark.parametrize("config", ["production", "invert", "dense", "weighting-conv",
                                    "matmul-wola"])
def test_multi_scene_graphed_equals_eager_on_the_card(dev, config):
    """MultiSceneApVast at N = 2, graphed against eager (graph=False), hop by
    hop from one state: outputs and state bit for bit, the same launch
    counts and rebuild decisions."""
    graphed = _multi_model(dev, config, 2)
    eager = _multi_model(dev, config, 2, graph=False)
    assert graphed.graphed and not eager.graphed
    rng = np.random.default_rng(14)
    for hop in range(8):
        eager.states = clone_state(graphed.states)
        a, b = rng.standard_normal((2, 2, 64)).astype(np.float32)
        K.reset_launch_counts()
        got = graphed.process_input_buffers(a, b)
        counts = K.launch_counts()
        K.reset_launch_counts()
        want = eager.process_input_buffers(a, b)
        assert counts == K.launch_counts() and sum(counts.values()) > 0, hop
        _assert_same(got, want, hop)
        _assert_same(graphed.states, eager.states, hop)
    assert int(graphed.silenced.sum()) == 0


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_fft_wola_replays_make_no_cufft_plan(dev, batched):
    """The production WOLA (cuFFT) under the graph: the warm pass before the
    captures makes every cuFFT plan the hop uses, so replays of both
    branches (warmup rebuilds, then tracked hops) add none to the plan
    cache; the plans are there."""
    cache = torch.backends.cuda.cufft_plan_cache[torch.cuda.current_device()]
    cache.clear()
    if batched:
        model = _multi_model(dev, "production", 3)
        shape = (2, 3, 64)
    else:
        model, _, _ = _graphed_pair(dev, "production")
        shape = (2, 64)
    assert model.graphed and not model.config.use_matmul_dft and model.plan.dft_cos is None
    rng = np.random.default_rng(16)
    model.process_input_buffers(*rng.standard_normal(shape).astype(np.float32))
    plans = cache.size
    assert plans > 0
    for _ in range(9):
        model.process_input_buffers(*rng.standard_normal(shape).astype(np.float32))
    assert 0 < model.rebuilds < 10 and cache.size == plans
    assert int(model.silenced.sum()) == 0


def test_batched_wola_launches_one_transform_for_all_scenes(dev):
    """The vmapped production hop launches the cuFFT kernels of one scene's
    hop whatever the scene count: no per-scene loop (device kernels by name
    under the profiler, one eager hop at N = 1 and N = 3)."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for n in (1, 3):
        model = _multi_model(dev, "production", n, graph=False)
        rng = np.random.default_rng(17)
        model.process_input_buffers(*rng.standard_normal((2, n, 64)).astype(np.float32))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.process_input_buffers(*rng.standard_normal((2, n, 64)).astype(np.float32))
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        counts[n] = sorted(x for x in names if "fft" in x.lower())
    assert counts[1] and counts[3] == counts[1], counts


@pytest.mark.parametrize("config", ["production", "invert", "dense", "weighting-conv"])
def test_multi_scene_matches_each_scenes_own_hop_on_the_card(dev, config):
    """Each scene of the graphed batched hop (N = 2) against that scene's
    own single-scene hop on the card from the same state, under the batched
    rebuild decision (which is any scene's own): statistics within 1e-4
    (K2's depth slices follow the path count, so its sums take another
    order), target feeds 1e-5, loudspeaker feeds 5e-2 at 8 Jacobi sweeps
    (2-3 unconverged sweeps amplify that rounding)."""
    from apvast_torch.engine.hop import rebuild_predicate
    from apvast_torch.parallel.mesh import scene_of

    model = _multi_model(dev, config, 2, jacobi_sweeps=8)
    cfg = model.config
    rng = np.random.default_rng(15)
    for hop in range(8):
        before = clone_state(model.states)
        a, b = (torch.from_numpy(x).to(dev)
                for x in rng.standard_normal((2, 2, 64)).astype(np.float32))
        out = model.process_input_buffers(a, b)
        stats = torch.func.vmap(lambda w, t: hop_statistics(cfg, w, t))(
            model.states.wresp_stat, model.states.wtarget_stat)
        own = []
        for k in range(2):
            state_k = clone_state(scene_of(before, k))
            if hasattr(state_k, "gevd_resid"):
                own.append(rebuild_predicate(cfg, state_k.gevd_hop, state_k.gevd_resid.item))
            new_k, want = process_hop(cfg, scene_of(model.plans, k), state_k, a[k], b[k],
                                      rebuild_override=out.rebuilt)
            for x, y in zip(stats, hop_statistics(cfg, new_k.wresp_stat, new_k.wtarget_stat)):
                assert _rel(x[k], y) <= 1e-4, (hop, k)
            for name, tol in (("out_a_t", 1e-5), ("out_b_t", 1e-5), ("out_a", 5e-2),
                              ("out_b", 5e-2)):
                assert _rel(getattr(out, name)[k], getattr(want, name)) <= tol, (hop, k, name)
        assert not own or out.rebuilt == any(own), hop
    assert int(model.silenced.sum()) == 0


@pytest.mark.parametrize("config", ["production", "invert"])
def test_multi_scene_launch_counts_equal_one_scene(dev, config):
    """Each kernel launches once a hop for all scenes (K10a once a panel):
    the counts at N = 2 are those at N = 1."""
    counts = []
    for n in (1, 2):
        model = _multi_model(dev, config, n)
        K.reset_launch_counts()
        rng = np.random.default_rng(16)
        for _ in range(3):
            model.process_input_buffers(*rng.standard_normal((2, n, 64)).astype(np.float32))
        counts.append(K.launch_counts())
    assert counts[0] == counts[1] and counts[0]["streaming_conv"] == 3


def test_fd_multi_scene_graphed_equals_eager_on_the_card(dev):
    """The batched FD hop (fd-jacobi, N = 2) captured (GraphedHop with
    batched=True) against the eager batched hop, hop by hop from one state:
    bit for bit, K1 and K7 once a hop."""
    from apvast_torch import ApVastConfig
    from apvast_torch.engine import build_plan, init_fd_state
    from apvast_torch.engine.graph import GraphedHop
    from apvast_torch.parallel import sharded_multi_scene_fd_hop
    from apvast_torch.parallel.mesh import stack_plans, stack_states

    kw = _fd_kwargs(np.random.default_rng(17), _GRAPHED_FD["fd-jacobi"])
    pairs = [(kw["rir_a"], kw["rir_b"]), (synthetic_rirs(120, 4, 3, seed=3),
                                          synthetic_rirs(120, 4, 3, seed=4))]
    cfg = ApVastConfig.for_rirs(
        *pairs[0], block_size=128, filter_length=16, modeling_delay=5, reference_index_a=1,
        reference_index_b=2, num_eigenvectors=4, mu=1.0, sampling_rate=8000, perceptual=True,
        dtype="float32", use_matmul_dft=True, use_pallas_conv=True, fd_eigh="jacobi")
    plans = stack_plans([build_plan(cfg, ra, rb, dev) for ra, rb in pairs])
    states = stack_states([init_fd_state(cfg, dev, generator=torch.Generator().manual_seed(i))
                           for i in range(2)])
    graph = GraphedHop(cfg, plans, states, 0.97, batched=True)
    hop = sharded_multi_scene_fd_hop(cfg, forgetting=0.97)
    rng = np.random.default_rng(18)
    for i in range(6):
        start = clone_state(graph.state)
        a, b = (torch.from_numpy(x).to(dev)
                for x in rng.standard_normal((2, 2, cfg.hop)).astype(np.float32))
        graph.stage(a, b)
        K.reset_launch_counts()
        got = graph.replay(False)
        counts = K.launch_counts()
        K.reset_launch_counts()
        new, want = hop(plans, start, a, b)
        assert counts == K.launch_counts() == {
            name: int(name in ("streaming_conv", "jacobi_eigh_hermitian")) for name in K.WRAPPERS}
        for name in ("out_a", "out_b", "out_a_t", "out_b_t", "silenced"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (i, name)
        _assert_same(graph.state, new, i)


def test_statistics_and_rowwise_conv_fold_scenes_bit_for_bit(dev):
    """K6 and K8 at N = 3 scenes in one launch against three single-scene
    launches: each scene's arithmetic is a single launch's, bit for bit."""
    g = torch.Generator().manual_seed(19)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    buf, tgt = rnd(12, 3, 8, 120), rnd(6, 3, 109)
    r, c = K.covariance(buf, tgt, 12)
    x, k_t = rnd(12, 3, 8, 96), rnd(6, 3, 16, 22)
    y = K.rowwise_circular_conv(x, k_t, 7, 16)
    for k in range(3):
        rk, ck = K.covariance(buf[4 * k : 4 * k + 4], tgt[2 * k : 2 * k + 2], 12)
        assert torch.equal(r[4 * k : 4 * k + 4], rk) and torch.equal(c[4 * k : 4 * k + 4], ck)
        yk = K.rowwise_circular_conv(x[4 * k : 4 * k + 4], k_t[2 * k : 2 * k + 2], 7, 16)
        assert torch.equal(y[4 * k : 4 * k + 4], yk)
    assert _rel(r, K.covariance_plain(buf, tgt, 12)[0]) <= 1e-4
    assert _rel(y, K.rowwise_circular_conv_plain(x, k_t, 7, 16)) <= 1e-4


# ---- evaluation slice: checkpoints, the MATLAB configuration, the bf16
# carry and offline VAST on the card ------------------------------------

_MATLAB_CARD = dict(statistics_half_form=False, normalize_statistics=True)


def _matlab_overrides():
    from apvast_torch.config import (
        RegularizationVariant,
        TargetFilterVariant,
        ToeplitzVariant,
        WeightingNorm,
    )

    return production_overrides() | _MATLAB_CARD | dict(
        toeplitz_variant=ToeplitzVariant.MATLAB,
        regularization=RegularizationVariant.MATLAB,
        weighting_norm=WeightingNorm.UNIT_SYMMETRIC,
        target_filter=TargetFilterVariant.PER_ZONE,
    )


@pytest.mark.parametrize("config", ["production", "tracking_li_bf16", "fd-jacobi"])
def test_checkpoint_resume_under_the_graph(dev, config, tmp_path):
    """A graphed model saved after hop 6, run on to hop 12; a fresh graphed
    model loaded from the file runs hops 7-12 with the same feeds, bit for
    bit (the bf16 carry read back as bfloat16)."""
    from apvast_torch.engine import FdState
    from apvast_torch.engine.state import ApVastState
    from apvast_torch.utils.checkpoint import load_state, save_state

    fd = config == "fd-jacobi"

    def model():
        rng = np.random.default_rng(21)
        if fd:
            return ApVastFD(device=dev, **_fd_kwargs(rng, {"fd_eigh": "jacobi"}))
        extra = {"tracking_li_bf16": True} if config == "tracking_li_bf16" else {}
        return ApVast(device=dev, **_s8_kwargs(rng, production_overrides() | extra))

    hops = np.random.default_rng(22).standard_normal((12, 2, 64)).astype(np.float32)
    first = model()
    assert first.graphed
    for a, b in hops[:6]:
        first.process_input_buffers(a, b)
    path = str(tmp_path / "state.npz")
    save_state(path, first.state)
    want = [first.process_input_buffers(a, b) for a, b in hops[6:]]
    second = model()
    second.state = load_state(path, second.config, FdState if fd else ApVastState, dev)
    if config == "tracking_li_bf16":
        assert second.state.gevd_minv.dtype == torch.bfloat16
    got = [second.process_input_buffers(a, b) for a, b in hops[6:]]
    for g_hop, w_hop in zip(got, want):
        for g, w in zip(g_hop, w_hop):
            assert torch.equal(g, w)
    assert int(first.silenced) == 0 and int(second.silenced) == 0


def test_matlab_configuration_on_the_card_matches_cpu(dev):
    """The MATLAB configuration on the production values (K1, K2, full-form
    K3, K4 at 8 sweeps, K5), hop by hop from the card's state: statistics
    1e-4, target feeds 1e-5, loudspeaker feeds 5e-2 of scale, nothing
    silenced; its launches are production's."""
    rng = np.random.default_rng(23)
    kwargs = _s8_kwargs(rng, _matlab_overrides() | {"jacobi_sweeps": 8})
    card, cpu = ApVast(device=dev, **kwargs), ApVast(device="cpu", graph=False, **kwargs)
    assert card.graphed
    feeds, targets = [], []
    counts = {name: 0 for name in K.WRAPPERS}
    for a, b in rng.standard_normal((8, 2, 64)).astype(np.float32):
        cpu.state = _state_to(clone_state(card.state), "cpu")
        K.reset_launch_counts()
        got = card.process_input_buffers(a, b)
        counts = {name: n + K.launch_counts()[name] for name, n in counts.items()}
        want = cpu.process_input_buffers(a, b)
        feeds.append((got[0], want[0]))
        targets.append((got[2], want[2]))
        for x, y in zip(
            hop_statistics(card.config, card.state.wresp_stat, card.state.wtarget_stat),
            hop_statistics(cpu.config, cpu.state.wresp_stat, cpu.state.wtarget_stat),
        ):
            assert _rel(x, y) <= 1e-4
    path = _PRODUCTION_KERNELS + _TRACKER_KERNELS
    assert counts == {name: 8 if name in path else 0 for name in K.WRAPPERS}
    for pairs, tol in ((feeds, 5e-2), (targets, 1e-5)):
        g = torch.stack([p[0] for p in pairs])
        assert torch.isfinite(g).all()
        assert _rel(g, torch.stack([p[1] for p in pairs])) <= tol
    assert int(card.silenced) == 0 and int(cpu.silenced) == 0


def test_bf16_carry_under_the_graph(dev):
    """tracking_li_bf16 graphed against eager from one state, 8 hops with
    rebuilds: the static carry stays bfloat16, the feeds agree as the
    graphed hop's do (1e-5 / 5e-2), the carry within one bfloat16 step."""
    rng = np.random.default_rng(24)
    kwargs = _s8_kwargs(rng, production_overrides() | {"tracking_li_bf16": True})
    graphed, eager = ApVast(device=dev, **kwargs), ApVast(device=dev, graph=False, **kwargs)
    assert graphed.graphed and graphed.state.gevd_minv.dtype == torch.bfloat16
    for hop in range(8):
        eager.state = clone_state(graphed.state)
        a, b = rng.standard_normal((2, 64)).astype(np.float32)
        got, want = graphed.process_input_buffers(a, b), eager.process_input_buffers(a, b)
        assert graphed.state.gevd_minv.dtype == eager.state.gevd_minv.dtype == torch.bfloat16
        assert _rel(graphed.state.gevd_minv, eager.state.gevd_minv) <= 2.0**-7
        for f in range(4):
            assert _rel(got[f], want[f]) <= (1e-5 if f >= 2 else 5e-2), (hop, f)
    assert graphed.rebuilds == eager.rebuilds >= 6
    assert int(graphed.silenced) == 0


def test_offline_sweep_float64_on_the_card_matches_cpu(dev):
    """vast_offline_sweep in float64 on the card against the CPU: 1e-6 of
    scale (cuSOLVER against LAPACK; the filters do not depend on the
    eigenvectors' signs)."""
    from apvast_torch.models.vast_offline import vast_offline_sweep

    rir_a, rir_b = synthetic_rirs(240, 8, 9, seed=31), synthetic_rirs(240, 8, 9, seed=32)
    args = (rir_a.astype(np.float64), rir_b.astype(np.float64), 24, 8, 2)
    kwargs = dict(num_eigenvectors=16, mu_grid=(0.1, 1.0, 10.0), num_steps=400)
    got = vast_offline_sweep(*args, **kwargs, device=dev)
    want = vast_offline_sweep(*args, **kwargs, device="cpu")
    assert got.device.type == "cuda" and got.dtype == torch.float64
    assert got.shape == (3, 16, 24, 8) and _rel(got, want) <= 1e-6


def test_metrics_graph_on_the_card(dev):
    """run_stream_with_metrics graphed (the hop's graph, then the metrics'
    graph on its static outputs): its outputs equal run_stream's bit for
    bit, and its metrics equal hop_metrics of those outputs computed
    eagerly on the card (1e-6 of each value)."""
    from apvast_torch.engine.hop import HopOutputs
    from apvast_torch.engine.stream import run_stream, run_stream_with_metrics
    from apvast_torch.observability import HopMetrics, hop_metrics

    rng = np.random.default_rng(25)
    kwargs = _s8_kwargs(rng, production_overrides())
    model = ApVast(device=dev, **kwargs)
    assert model.graphed
    x = torch.from_numpy(rng.standard_normal((2, 12 * 64)).astype(np.float32)).to(dev)
    state = clone_state(model.state)
    _, outs = run_stream(model.config, model.plan, state, x[0], x[1])
    _, got, metrics = run_stream_with_metrics(model.config, model.plan, state, x[0], x[1],
                                              kwargs["rir_a"], kwargs["rir_b"])
    names = ("out_a", "out_b", "out_a_t", "out_b_t", "silenced")
    for name in names:
        assert torch.equal(getattr(got, name), getattr(outs, name)), name
    rir_a, rir_b = (torch.as_tensor(kwargs[k]).to(dev, torch.float32) for k in ("rir_a", "rir_b"))
    for i in range(12):
        want = hop_metrics(HopOutputs(**{n: getattr(outs, n)[i] for n in names}), rir_a, rir_b)
        for f in dataclasses.fields(HopMetrics):
            g = getattr(metrics, f.name)[i]
            assert g.device.type == "cuda"
            torch.testing.assert_close(g, getattr(want, f.name), rtol=1e-6, atol=0,
                                       equal_nan=True)


def test_residual_precision_default_on_the_card_matches_cpu(dev):
    """tracking_residual_precision="default", graphed, hop by hop from the
    card's state against the CPU (whose hop the CPU tests hold to the JAX
    engine's with its DEFAULT products given bfloat16 operands), K4 at 8
    sweeps as the other paths' feeds are held: the same silenced count on
    every hop, target feeds 1e-5 and loudspeaker feeds 5e-2 of scale."""
    rng = np.random.default_rng(26)
    kwargs = _s8_kwargs(rng, production_overrides() | {"tracking_residual_precision": "default",
                                                       "jacobi_sweeps": 8})
    card, cpu = ApVast(device=dev, **kwargs), ApVast(device="cpu", graph=False, **kwargs)
    assert card.graphed
    feeds, targets, silenced = [], [], []
    for a, b in rng.standard_normal((12, 2, 64)).astype(np.float32):
        cpu.state = _state_to(clone_state(card.state), "cpu")
        before = (int(card.silenced), int(cpu.silenced))
        got, want = card.process_input_buffers(a, b), cpu.process_input_buffers(a, b)
        silenced.append((int(card.silenced) - before[0], int(cpu.silenced) - before[1]))
        feeds.append((got[0], want[0]))
        targets.append((got[2], want[2]))
    assert all(c == h for c, h in silenced), silenced
    for pairs, tol in ((feeds, 5e-2), (targets, 1e-5)):
        g = torch.stack([p[0] for p in pairs])
        assert torch.isfinite(g).all()
        assert _rel(g, torch.stack([p[1] for p in pairs])) <= tol


def test_hop_meter_marks_both_branch_graphs(dev):
    """The production hop's two branch graphs each have a twin that
    carries the hop meter's seven timed marks, and a sampled replay of
    each branch replays the twin and is read at the next replay (hops
    whose feeds the caller waits for, as a closed loop does)."""
    from apvast_torch.observability import MARKS, SAMPLE_EVERY, SECTIONS, meter

    rng = np.random.default_rng(27)
    model = ApVast(device=dev, **_s8_kwargs(rng, production_overrides()))
    graph = model.graph
    assert set(graph.marked) == {False, True}
    for b in (False, True):
        twin, events = graph.marked[b]
        assert len(events) == len(MARKS) and twin is not graph.graphs[b]
    m = meter()
    m.reset()
    m._branch_replays = [SAMPLE_EVERY - 1] * 2  # each branch's next replay is sampled
    hops = 40
    for a, b in rng.standard_normal((hops, 2, 64)).astype(np.float32):
        model.process_input_buffers(a, b)
        torch.cuda.synchronize()
    w = m.window(hops)
    assert w.samples() == {True: (1, 0), False: (1, 0)}
    assert all(w.section_ms(s) > 0 for s in SECTIONS)
    assert w.host_ms("launch") > 0 and w.host_ms("stage") > 0


@pytest.mark.parametrize("rebuilt", [False, True], ids=["no-rebuild", "rebuild"])
def test_hop_meter_twin_replays_bit_for_bit(dev, rebuilt):
    """A branch's marked twin and its graph without marks, replayed from
    one saved state on the same inputs: outputs and state bit for bit."""
    graphed, _, rng = _graphed_pair(dev, "production")
    for _ in range(7):  # past the warmup
        graphed.process_input_buffers(*rng.standard_normal((2, 64)).astype(np.float32))
    saved = clone_state(graphed.state)
    a, b = (torch.from_numpy(x).to(dev) for x in rng.standard_normal((2, 64)).astype(np.float32))
    runs = []
    for replay in (graphed.graph.graphs[rebuilt].replay, graphed.graph.marked[rebuilt][0].replay):
        graphed.state = saved
        graphed.graph.stage(a, b)
        replay()
        out = graphed.graph.out
        runs.append(([out.out_a.clone(), out.out_b.clone(), out.out_a_t.clone()],
                     clone_state(graphed.graph.state)))
    torch.cuda.synchronize()
    (outs, state), (want_outs, want_state) = runs
    for x, y in zip(outs, want_outs):
        assert torch.equal(x, y)
    for f in dataclasses.fields(state):
        x, y = getattr(state, f.name), getattr(want_state, f.name)
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, f.name


@pytest.mark.parametrize("rebuilt", [False, True])
def test_hop_meter_sections_sum_to_the_replay(dev, rebuilt):
    """The hop's six sections of a replay add up to within 5 % of a timing
    event pair recorded around it, and ``pencils`` + ``factor`` +
    ``track`` + ``synth`` to within 3 % of ``solve`` (means of 10 replays
    of the branch); the marks come in ``MARKS``' order, each section's
    time is at least 0, and the factorization takes time on the rebuild
    branch alone."""
    from apvast_torch.observability import MARKS, SECTIONS

    rng = np.random.default_rng(28)
    model = ApVast(device=dev, **_s8_kwargs(rng, production_overrides()))
    twin, marks = model.graph.marked[rebuilt]
    assert len(marks) == len(MARKS)
    outer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    sums, spans, sections = [], [], []
    for a, b in rng.standard_normal((12, 2, 64)).astype(np.float32):
        model.graph.stage(a, b)
        outer[0].record()
        twin.replay()
        outer[1].record()
        torch.cuda.synchronize()
        spans.append(outer[0].elapsed_time(outer[1]))
        sections.append({k: marks[MARKS.index(x)].elapsed_time(marks[MARKS.index(y)])
                         for k, (x, y) in SECTIONS.items()})
        sums.append(sum(list(sections[-1].values())[:6]))
    got, want = np.mean(sums[2:]), np.mean(spans[2:])
    assert abs(got - want) <= 0.05 * want, (got, want)
    mean = {k: np.mean([row[k] for row in sections[2:]]) for k in SECTIONS}
    assert all(v >= 0 for v in mean.values()), mean
    parts = mean["pencils"] + mean["factor"] + mean["track"] + mean["synth"]
    assert abs(parts - mean["solve"]) <= 0.03 * mean["solve"], mean
    if rebuilt:
        assert mean["factor"] > 0.02, mean
    else:
        assert mean["factor"] < 0.01, mean


def test_hop_meter_adds_no_sync(dev):
    """Graphed hops with the meter return while a long kernel queued
    before them still runs: neither a sampled replay nor the read of its
    sections at the next hop waits for the device (warmup hops, which read
    no residual, on inputs already on the card: a copy from pageable host
    memory waits for the stream)."""
    from apvast_torch.observability import SAMPLE_EVERY, meter

    rng = np.random.default_rng(29)
    model = ApVast(device=dev, **_s8_kwargs(rng, production_overrides()))
    m = meter()
    m.reset()
    m._branch_replays = [SAMPLE_EVERY - 1] * 2  # the next replay is sampled
    hops = torch.from_numpy(rng.standard_normal((2, 2, 64)).astype(np.float32)).to(dev)
    done = torch.cuda.Event()
    torch.cuda._sleep(2_000_000_000)  # about a second
    done.record()
    for a, b in hops:
        model.process_input_buffers(a, b)
    assert not done.query(), "a metered hop waited for the device"
    assert m.window(2).samples() == {True: (0, 1)}
    torch.cuda.synchronize()


def test_trace_puts_launch_around_cuda_graph_launch(dev, tmp_path):
    """Under observability.trace the Chrome trace holds the meter's spans
    as user annotations, and every cudaGraphLaunch lies inside a
    ``launch`` span (inside an ``entry``)."""
    import json
    import os

    from apvast_torch.observability import trace

    rng = np.random.default_rng(30)
    model = ApVast(device=dev, **_s8_kwargs(rng, production_overrides()))
    with trace(str(tmp_path)):
        for a, b in rng.standard_normal((8, 2, 64)).astype(np.float32):
            model.process_input_buffers(a, b)
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def spans(name, cat=None):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e["name"] == name and (cat is None or e.get("cat") == cat)]

    launches = spans("launch", "user_annotation")
    entries = spans("entry", "user_annotation")
    graph_launches = spans("cudaGraphLaunch")
    assert len(launches) == len(entries) == 8 and len(graph_launches) == 8
    for t0, t1 in graph_launches:
        assert any(a <= t0 and t1 <= b for a, b in launches)
    for t0, t1 in launches:
        assert any(a <= t0 and t1 <= b for a, b in entries)
