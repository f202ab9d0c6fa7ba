"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # phases 0-3, needs one CUDA card
    python3 chip_smoke.py --profile  # also phase 4: a torch.profiler
                                     # breakdown of 32 steady-state hops

Phase 0  environment: card name and power limit, torch/CUDA versions,
         TF32 off for matmuls and cuDNN.
Phase 1  build: every kernel of apvast_torch/csrc with nvcc (one process
         per source, all at once): K1-K6, K7 (a form of K4's source), K8,
         K9, K10a, K10b and K11 (a form of K5's source).
Phase 2  each kernel against its plain PyTorch version on the card, at the
         north-star shapes and at ragged small shapes:
         max|kernel - plain| / max|plain| <= 1e-4 (fp32 sums taken in
         another order). K3 in both forms; K4 at (2, 64, 64) with 2 sweeps
         on a warm-start-like (near-diagonal) input and with 8 sweeps on a
         cold random one (eigenvector columns compared up to sign: a
         converged column's sign is the rotation history's choice), and at
         3 sweeps on the invert path's own Rayleigh-Ritz matrices (captured
         from its first hops on the card), where rounding picks rotations
         and the eigenvectors are chaotic: there the eigenvalues, their
         agreement with diag(V^T h V), V's orthonormality and the
         off-diagonal remainder (within 1.5x the plain version's) are held.
         K10a also on an ill-conditioned panel (its whitening residual
         within 2x that of cholesky_ex + solve_triangular) and on a non-PD
         one (non-finite output). K7 at (1602, 16, 16) and (1602, 32, 32)
         complex with 6 cold sweeps (the FD engine's per-bin pencils at B = 1
         and 2), at a ragged (3, 5, 5), and on the degenerate-pairs spectrum
         of tests/test_jacobi_eigh.py at 10 sweeps: its eigenvectors are
         defined up to a phase that rounding picks inside every doubled
         eigenvalue of the real embedding, so the eigenvalues are held
         against the plain version's (1e-4 of scale), and the residual
         max|Hq - qw| / max|H| and max|q^H q - I| of each matrix, averaged
         over the batch, within 1e-4 or 1.5x the plain version's (six cold
         sweeps leave the near-degenerate pairs of random matrices
         unconverged on either device, so the worst matrix is reported
         beside the plain version's own worst under 1e-7 input changes).
         K7 at (1602, 16, 16) and (1602, 32, 32) also against K4's kernel
         on the real embedding with select_pairs (the same rotations:
         eigenvalues to 1e-5 of scale). K6 at the north-star shapes, at SJ = 1600
         (S = 32, the JAX package's packed regime) and at a ragged SJ = 300;
         K8 at the north-star shapes with the banded k_t of T = 257
         weighting taps (also against a float64 oracle, 1e-5 of scale, and
         with one NaN sample: NaN in exactly the outputs of the two frames
         whose full-depth windows hold it, as in the plain version) and at
         (4, 2, 3, 64) and (4, 2, 17, 96) with a general k_t; K11 at
         (2, 1600) x (2, 800, 50), at 37 rows (no whole row tile) and at
         1000 rows (the JAX function pads them). K10b (no engine caller) at (2, 800, 800), (1, 200, 200)
         and (1, 1024, 1024) against its plain version and against a float64
         oracle, both within 1e-5 of scale (the JAX package's bound), with
         exact zeros above the diagonal; on an ill-conditioned batch (its
         whitening residual within 2x that of cholesky_ex +
         solve_triangular) and a non-PD one (non-finite output); timed beside
         two chains: (a) cholesky_ex + solve_triangular, (b) the invert
         path's blocked_cholesky (K10a x 7) + triangular_inverse. K4 and K7
         past 128 slots (the wide shared form and the global-memory form):
         warm-start-like (2, 136), (2, 200), (2, 256) real and (64, 72),
         (2, 128) complex at 8 sweeps, eigenvalues to 1e-4 of scale and the
         eigenvector residual and orthonormality within 1.5x the plain
         version's. K1 and K6, whose products run on the tensor cores in
         3xTF32, also against a float64 oracle (the plain version in float64
         on the card) at every shape above: per output, max|kernel - oracle| /
         max|oracle| within 2x the plain float32 version's own error against
         it. Times
         by CUDA events after warm-up, with the 50 MB L2 flushed (a 64 MB
         read) before every launch; the bound is the larger of bytes over
         3.35 TB/s and fp32 operations over 67 TFLOP/s (H100 SXM published
         peaks), for K1 and K6 three TF32 passes of their products over 495
         TFLOP/s (their fp32 bound printed beside it). K1's yardstick is the
         one cuBLAS matmul of its plain version (F.conv1d beside it).
Phase 3  the main path, ``ApVast`` on ``scale_scene(16)`` for 64 hops (two
         rebuild periods) on the card, input and initial noise from a seed,
         in five configurations:
         production ``production_overrides()`` (the tracking GEVD solver
                    with K4, half-form K3): K1-K5 each launched once per
                    hop, ``silenced == 0``, the rebuild count and residual
                    range, and each of the first 8 hops against the same
                    hop on the CPU (plain versions) from the card's state:
                    half-form statistics (M, r) to 1e-4 of their scale,
                    target feeds to 1e-4, loudspeaker feeds printed; then,
                    in a second run with K4 at 8 sweeps, the same with the
                    loudspeaker feeds to 5e-2 of signal scale.
                    (Free-running, 2 unconverged Jacobi sweeps let rounding
                    pick between +-45 degree rotations, so the comparison
                    starts every hop from one state; and within one hop, 2
                    sweeps part the feeds by rounding alone, see below.)
         exact      ``production_overrides() | {gevd_solver: EIGH}``: K1,
                    K2, K3 (full form) and K5 once per hop, no K4, and the
                    first 8 hops against a free-running CPU run with the
                    same tolerances (R in full form).
         invert     ``production_overrides() | {subspace_whiten: "invert",
                    jacobi_sweeps: 3, use_pallas_subspace: True,
                    use_pallas_whiten: True}`` (the round-3 solver): K1-K5
                    and K9 once per hop, K10a 7 times (JL = 800 pads to 7
                    panels), full-form K3.
         dense      ``production_overrides() | {use_lag_statistics: False}``:
                    K1, K6, K4 (the tracking solver fed the full-form R) and
                    K5 once per hop.
         weighting-conv ``production_overrides() | {weighting_conv_taps:
                    257}`` (the truncated time-domain weighting): K1, K8,
                    K2, K3 (half form), K4 and K5 once per hop.
         Then 8 hops each of ``production_overrides() | {subspace_whiten:
         "solve"}`` and ``{... "newton"}`` (K4 at 2 sweeps, no K9 or K10a).
         Under these three solvers K4's 2-3 sweeps are unconverged on a
         Rayleigh-Ritz matrix that is not near-diagonal, and the loudspeaker
         feeds of single hops part from the CPU's by rounding (up to 0.6 of
         scale). So each of the three is compared with the CPU, as the
         production path: hop by hop from the card's state, statistics and
         target feeds (which come before the solver) on the configured run,
         and all of it, to the same tolerances, in a second run of 8 hops
         with K4 at 8 sweeps (converged). The production, the dense and the
         weighting-conv path are compared the same way: K1 and K6 sum in another order than
         their plain versions (3xTF32 on the tensor cores, about 3e-6 and
         6e-6 of scale), and at 2 sweeps that moved single hops' feeds by
         up to 0.28 of their own scale (0.07 of the 8 hops' signal scale).
         Contrast gate: acoustic contrast of zone A over hops 7-64 at rank 1
         and rank V (= 50), computed with ``apvast_torch.evaluation``; the
         production, the invert and the dense path must each be within 0.25
         dB of the exact path at both ranks (the JAX package's gate,
         tools/tracking_gate.py and tests/test_jacobi_eigh.py), and the
         weighting-conv path within 0.25 dB of the production path (the JAX
         package's truncation gate, tests/test_weighting_conv.py).
         Then the frequency-domain engine, ``ApVastFD`` on the same scene
         with bench.py's FD settings (forgetting 0.97, mu 1, matmul DFT, K1),
         V = 16 per bin:
         fd-jacobi  ``fd_eigh="jacobi"`` (K7, 6 sweeps), every rank 1..16,
                    64 hops: K1 and K7 once per hop, ``silenced == 0``; hops
                    1-8 against the CPU from the card's state: per-bin
                    statistics (cov, cross) to 1e-4 of scale, target feeds to
                    1e-4, loudspeaker feeds to the larger of 1e-3 and 4x the
                    spread of the CPU hop itself under 1e-7 relative changes
                    of its state (at most 5e-2).
         fd-lapack  the same with ``torch.linalg.eigh``: the oracle. fd-jacobi's
                    zone-A contrast over hops 7-64 within 0.25 dB of it at rank
                    1 and rank 16.
         fd-full    ``fd_span="full"``, the low-cost point: K1 per hop, no K7.
         fd-coupled ``fd_span="full"``, C = 7, B = 2, V = 32: the coupled
                    quality point.
         and 8 hops each of fd-full with C = 7, G = 4 and a 1e-3 rank cutoff,
         and with 4 CG refinement steps. Contrast and NMSE (rank V) are
         reported for every FD path, and every path's first 8 hops are held
         against the CPU (loudspeaker feeds to 5e-2 of scale outside the
         Jacobi path).
Phase 4  (``--profile``) device time by kernel and by stage over 32
         steady-state hops of the production, the invert, the dense, the
         weighting-conv, the fd-jacobi and the fd-full path, and the
         device's idle share.

The last line of output is ``{"ok": true, "device": {...}}``; any failure
exits non-zero before it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
TOL_KERNEL = 1e-4
# K10b against its plain version and a float64 oracle: the JAX package's own
# bound for the TPU kernel (tests/test_whiten_kernel.py).
TOL_CHOL_TRI = 1e-5
# K4 and K7 past 128 slots: (batch, n, complex), 8 sweeps.
WIDE_JACOBI = ((2, 136, False), (2, 200, False), (2, 256, False), (64, 72, True),
               (2, 128, True))
WIDE_SWEEPS = 8
TOL_STATS = 1e-4
TOL_TARGET = 1e-4
TOL_FEEDS = 5e-2
TOL_CONTRAST_DB = 0.25
HOPS = 64
CPU_HOPS = 8
TAIL_FROM = 6  # contrast over hops 7-64 (0-based 6-63)
PROFILE_HOPS = 32
SEED = 20261016
# The frequency-domain engine: bench.py's FD settings, K7's cold sweeps
# (config.fd_jacobi_sweeps), and the Jacobi path's loudspeaker-feed gate
# against the CPU: the larger of FD_TOL_FLOOR and FD_SPREAD_FACTOR x the
# CPU hop's own spread under ULP_REL changes of its state, at most TOL_FEEDS.
FD_SETTINGS = {"use_matmul_dft": True, "use_pallas_conv": True}
FD_FORGETTING = 0.97
FD_SWEEPS = 6
FD_TOL_FLOOR = 1e-3
FD_SPREAD_FACTOR = 4.0
HERM_RATIO = 1.5  # K7's residual and orthonormality against its plain version's
# K7 against K4's kernel on the real embedding (the same rotations), and K8
# against a float64 oracle: rounding only.
TOL_SAME_ROTATIONS = 1e-5
TOL_ORACLE = 1e-5
# K1 and K6 (3xTF32) against a float64 oracle: at most this times the plain
# float32 version's own error against it.
TOL_ORACLE_RATIO = 2.0
# The truncated weighting's tap count: the JAX package's production value
# (tools/device_breakdown.py, tests/test_weighting_conv.py).
WEIGHTING_TAPS = 257


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, L2 flushed
    before each by reading a buffer larger than it (a read leaves no dirty
    lines whose write-back would land inside the timed launch)."""
    for _ in range(3):
        fn()
    total = 0.0
    events = []
    for _ in range(iters):
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    for start, end in events:
        total += start.elapsed_time(end)
    return total / iters


def _rel(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max abs difference, that over max |b|)."""
    a, b = (x.cdouble() if x.is_complex() else x.double() for x in (a, b))
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    return diff, diff / max(scale, 1e-30)


def _check(name: str, rel: float, tol: float) -> None:
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {tol:.0e}")


def _errs(got, want, up_to_sign=False):
    """[(max abs, relative)] per output; ``up_to_sign`` matches the sign of
    each eigenvector column (the second output) to the plain version's."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if up_to_sign:
        sign = torch.sign((got[1] * want[1]).sum(-2, keepdim=True))
        got = (got[0], got[1] * torch.where(sign == 0, 1.0, sign))
    return [_rel(a, b) for a, b in zip(got, want)]


def _warm(g, dev, b, n):
    """A warm-start-like Rayleigh-Ritz matrix: spread diagonal plus a small
    symmetric perturbation."""
    e = 1e-2 * torch.randn((b, n, n), generator=g)
    d = torch.diag_embed(torch.linspace(-3.0, 5.0, n).repeat(b, 1))
    return (d + (e + e.transpose(1, 2)) / 2).to(dev).contiguous()


def _cold(g, dev, b, n):
    x = torch.randn((b, n, n), generator=g)
    return ((x + x.transpose(1, 2)) / 2).to(dev).contiguous()


def _hermitian(g, dev, b, n):
    x = torch.complex(torch.randn((b, n, n), generator=g), torch.randn((b, n, n), generator=g))
    return ((x + x.conj().transpose(1, 2)) / 2).to(dev).contiguous()


def _warm_hermitian(g, dev, b, n):
    """The complex counterpart of _warm: a spread real diagonal plus a small
    Hermitian perturbation."""
    d = torch.diag_embed(torch.linspace(-3.0, 5.0, n).repeat(b, 1)).to(torch.complex64)
    return (d.to(dev) + 1e-2 * _hermitian(g, dev, b, n)).contiguous()


def _degenerate_pairs(dev):
    """tests/test_jacobi_eigh.py's spectrum: two exact 2-fold degeneracies
    and a pair 1 float32 ulp apart, (6, 8, 8) complex."""
    rng = np.random.default_rng(SEED)
    z = rng.standard_normal((6, 8, 8)) + 1j * rng.standard_normal((6, 8, 8))
    q, _ = np.linalg.qr(z)
    w0 = np.array([1.0, 1.0, 2.0, 2.0, 3.0, np.float32(3.0) + np.spacing(np.float32(3.0)),
                   5.0, 8.0])
    a = (q * w0.astype(q.dtype)) @ np.conj(q.swapaxes(-1, -2))
    return torch.from_numpy((0.5 * (a + np.conj(a.swapaxes(-1, -2)))).astype(np.complex64)).to(dev)


def _hermitian_state(h, w, q):
    """Per matrix, in float64: max |Hq - qw| / max |H| and max |q^H q - I|."""
    h, q = h.cdouble(), q.cdouble()
    res = (h @ q - q * w.double()[:, None, :]).abs().amax((1, 2)) / h.abs().amax((1, 2))
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return res, (q.conj().transpose(1, 2) @ q - eye).abs().amax((1, 2))


def _hermitian_checks(K, cases, card):
    """K7 against its plain version on (label, h, sweeps) cases: the
    eigenvalues to TOL_KERNEL of scale; the kernel's residual and
    orthonormality, per matrix and then averaged over the batch, within
    the larger of TOL_KERNEL and HERM_RATIO x the plain version's. The
    worst matrix is reported with the plain version's own worst under
    ULP_REL input changes (3 draws): after six cold sweeps the
    near-degenerate pairs of a random matrix are unconverged, and rounding
    picks their basis (PERF.md, section 6)."""
    g = torch.Generator().manual_seed(SEED)
    for label, h, sweeps in cases:
        w, q = K.jacobi_eigh_hermitian(h, sweeps)
        wp, qp = K.jacobi_eigh_hermitian_plain(h, sweeps)
        d_rel = _rel(w, wp)[1]
        got, plain = _hermitian_state(h, w, q), _hermitian_state(h, wp, qp)
        own = [0.0, 0.0]
        for _ in range(3):
            hp = h * (1 + ULP_REL * torch.randn(h.shape, generator=g).to(h.device))
            hp = ((hp + hp.conj().transpose(1, 2)) / 2).contiguous()
            for i, x in enumerate(_hermitian_state(hp, *K.jacobi_eigh_hermitian_plain(hp, sweeps))):
                own[i] = max(own[i], float(x.max()))
        print(f"[phase 2] jacobi_eigh_hermitian {label} {tuple(h.shape)}, {sweeps} sweeps: "
              f"eigenvalues rel_err={d_rel:.3e}; residual mean {float(got[0].mean()):.3e} "
              f"(plain {float(plain[0].mean()):.3e}), worst {float(got[0].max()):.3e} (plain "
              f"{float(plain[0].max()):.3e}, under {ULP_REL:.0e} input changes {own[0]:.3e}); "
              f"max |q^H q - I| mean {float(got[1].mean()):.3e} (plain "
              f"{float(plain[1].mean()):.3e}), worst {float(got[1].max()):.3e} (plain "
              f"{float(plain[1].max()):.3e}, under {ULP_REL:.0e} input changes {own[1]:.3e}) "
              f"card={card}", flush=True)
        _check(f"jacobi_eigh_hermitian {label} eigenvalues", d_rel, TOL_KERNEL)
        for name, x, xp in zip(("residual", "orthonormality"), got, plain):
            limit = max(TOL_KERNEL, HERM_RATIO * float(xp.mean()))
            if not float(x.mean()) <= limit:
                raise AssertionError(f"jacobi_eigh_hermitian {label}: mean {name} "
                                     f"{float(x.mean()):.3e} > {limit:.3e}")


def _hermitian_against_k4(K, cases, card):
    """K7 on (label, h) at FD_SWEEPS against K4's kernel on embed(h) with
    select_pairs: the same rotations in the same order, so the eigenvalues
    agree to TOL_SAME_ROTATIONS of scale."""
    from apvast_torch.ops.kernels.jacobi_eigh_hermitian import embed, select_pairs

    for label, h in cases:
        w = K.jacobi_eigh_hermitian(h, FD_SWEEPS)[0]
        w_ref = select_pairs(*K.jacobi_eigh(embed(h), FD_SWEEPS), h.shape[-1])[0]
        diff, rel = _rel(w, w_ref)
        print(f"[phase 2] jacobi_eigh_hermitian {label} {tuple(h.shape)} against K4 on the "
              f"embedding: eigenvalues rel_err={rel:.3e} max_abs_err={diff:.3e} card={card}",
              flush=True)
        _check(f"jacobi_eigh_hermitian {label} against K4 on the embedding", rel,
               TOL_SAME_ROTATIONS)


def _rowwise_checks(K, x, k_t, taps, b, card):
    """K8 against a float64 oracle (its plain version in double precision)
    within TOL_ORACLE of scale; and with one NaN sample, NaN in exactly the
    outputs whose full-depth window holds it (those of the plain version:
    every output of the two frames whose windows cover it), the rest within
    TOL_KERNEL of the plain version."""
    got = K.rowwise_circular_conv(x, k_t, taps, b)
    diff, rel = _rel(got, K.rowwise_circular_conv_plain(x.double(), k_t.double(), taps, b))
    print(f"[phase 2] rowwise_conv against float64: rel_err={rel:.3e} max_abs_err={diff:.3e} "
          f"card={card}", flush=True)
    _check("rowwise_conv against float64", rel, TOL_ORACLE)
    xn = x.clone()
    xn[1, 0, 3, 5] = float("nan")  # inside the circular halo of the last frame
    got = K.rowwise_circular_conv(xn, k_t, taps, b)
    want = K.rowwise_circular_conv_plain(xn, k_t, taps, b)
    nan, nan_plain = torch.isnan(got), torch.isnan(want)
    count = int(nan.sum())
    print(f"[phase 2] rowwise_conv with one NaN sample: {count} NaN outputs (plain "
          f"{int(nan_plain.sum())}, want 2 frames x {b}) card={card}", flush=True)
    if not torch.equal(nan, nan_plain) or count != 2 * b:
        raise AssertionError("rowwise_conv: NaN outputs differ from the plain version's")
    _check("rowwise_conv with one NaN sample, the finite outputs",
           _rel(got[~nan_plain], want[~nan_plain])[1], TOL_KERNEL)


def _oracle_checks(name, shapes, card):
    """Each (label, kernel, plain, args) of ``shapes``, per output: the
    kernel's error against a float64 oracle (the plain version in float64),
    max|x - oracle| / max|oracle|, within TOL_ORACLE_RATIO x the plain float32
    version's own. Both printed."""
    for label, kfn, pfn, args in shapes:
        got, want = kfn(*args), pfn(*args)
        oracle = pfn(*(a.double() for a in args))
        torch.cuda.synchronize()
        got, want, oracle = (x if isinstance(x, tuple) else (x,) for x in (got, want, oracle))
        for i, (g_, w_, o_) in enumerate(zip(got, want, oracle)):
            e_k, e_p = _rel(g_, o_)[1], _rel(w_, o_)[1]
            print(f"[phase 2] {name} {label} output {i} against float64: kernel {e_k:.3e}, "
                  f"plain float32 {e_p:.3e} (ratio {e_k / max(e_p, 1e-30):.2f}, limit "
                  f"{TOL_ORACLE_RATIO}) card={card}", flush=True)
            if not e_k <= TOL_ORACLE_RATIO * e_p:
                raise AssertionError(f"{name} {label} output {i}: error against float64 "
                                     f"{e_k:.3e} > {TOL_ORACLE_RATIO} x plain's {e_p:.3e}")


def phase2(scene, dev, card):
    from apvast_torch.engine.plan import build_plan
    from apvast_torch.ops import kernels as K
    from apvast_torch.ops.framing import framed_statistics
    from apvast_torch.ops.jdiag import _topk_project
    from apvast_torch.ops.trisolve import triangular_inverse
    from apvast_torch.ops.weighting_conv import _banded_toeplitz_t, weighting_kernel

    cfg = scene.config
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float32).to(dev)

    plan = build_plan(cfg, scene.rir_a, scene.rir_b, dev)
    m, s, j, hop, block = (
        cfg.num_mics, cfg.num_srcs, cfg.filter_length, cfg.hop, cfg.block_size
    )
    v = cfg.num_solutions
    F = torch.nn.functional
    flush = torch.zeros(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    results = []

    # K1 streaming convolution: segments (2, fir_fft_size), rows 2MS+M.
    seg = rnd(2, cfg.fir_fft_size) * 1e-1
    kern = plan.conv_kernels
    taps, rows = kern.shape[-1], kern.shape[1]
    hist = seg.shape[-1] - hop
    conv_w = kern.flip(-1).reshape(2 * rows, 1, taps)
    conv_in = seg[None, :, hist - taps + 1 :].contiguous()

    # K2 lag correlations: (4, M, S+1, N-1) with the target row, J lags.
    x2 = rnd(4, m, s + 1, cfg.statistics_buffer_length - 1) * 1e-3
    n2 = x2.shape[-1]
    k2 = n2 - j + 1
    c0_in = x2.permute(2, 0, 1, 3).reshape(s + 1, 4 * m, n2).contiguous()
    c0_w = x2[..., :k2].permute(0, 2, 1, 3).reshape(4 * (s + 1), m, k2).contiguous()

    # K3 skew assembly: lhsT (4, J*S, 2M), rhs (4, 2M, S*J), c0 (4, S, S*J).
    lhs3, rhs3, c03 = rnd(4, j * s, 2 * m), rnd(4, 2 * m, s * j), rnd(4, s, s * j)

    # K4 Jacobi: the tracking solver's (2, k, k) Rayleigh-Ritz matrices,
    # k = V + oversample = 64, 2 sweeps (production_overrides()).
    k4 = min(v + 14, cfg.jl)
    npad = -(-k4 // 8) * 8
    h_warm, h_cold = _warm(g, dev, 2, k4), _cold(g, dev, 2, k4)

    # K7: the FD engine's whitened per-bin pencils, (2 * bins, S * B, S * B)
    # complex at B = 1 and 2, FD_SWEEPS cold sweeps.
    bins = cfg.num_bins
    h7, h7b = _hermitian(g, dev, 2 * bins, s), _hermitian(g, dev, 2 * bins, 2 * s)
    np7 = -(-2 * s // 8) * 8

    # K10a: random SPD panels of the main path's shape (2, 128, 128); an
    # ill-conditioned and a non-PD panel beside them.
    def spd(b, n, boost=0.0):
        x = torch.randn((b, n, n), generator=g, dtype=torch.float32)
        out = x @ x.transpose(1, 2) / n + torch.eye(n)
        if boost:
            out[0] += boost * torch.outer(x[0, 0], x[0, 0]) / n
        return out.to(dev).contiguous()

    panel = spd(2, 128)
    eye128 = torch.eye(128, device=dev)

    # K9: random SPD matrices and inverse Cholesky factors (lower triangular)
    # of the main path's shapes (2, 800, 800), a (2, 800, 64) warm start, 2
    # iterations (production_overrides()' subspace_iters).
    jl, k9 = cfg.jl, min(v + 14, cfg.jl)
    a9 = spd(2, jl)
    li9 = torch.linalg.inv(torch.linalg.cholesky(spd(2, jl))).contiguous()
    q9 = rnd(2, jl, k9)
    r200 = (spd(2, 200), torch.linalg.inv(torch.linalg.cholesky(spd(2, 200))).contiguous(),
            rnd(2, 200, 24))

    # K10b: random SPD matrices of the main path's shape (2, JL, JL), which
    # pads to 896, of a padded (1, 200, 200) and of the largest padded size.
    b10, b10_200, b10_1024 = spd(2, jl), spd(1, 200), spd(1, 1024)
    eye_jl = torch.eye(jl, device=dev)

    # K5 output filter: windowed block (2, block), V*S filter rows.
    x5 = (plan.window * rnd(2, block)).contiguous()
    f5, t5 = rnd(2, v * s, j) * 1e-2, rnd(2, v * s, block - hop) * 1e-2
    ext5 = torch.cat([x5[:, block - (j - 1) :], x5], -1)[None].contiguous()
    w5 = f5.flip(-1).reshape(2 * v * s, 1, j).contiguous()

    # K6 dense statistics: the deleted-form buffers (4, M, S, N - 1) and the
    # aligned targets (2, M, K); SJ = 1600 (S = 32) and a ragged SJ = 300.
    n6 = cfg.statistics_buffer_length - 1
    k6 = n6 - j + 1
    buf6, tgt6 = rnd(4, m, s, n6) * 1e-3, rnd(2, m, k6) * 1e-3
    buf6w = rnd(4, m, 2 * s, n6) * 1e-3
    sj = s * j

    # K8 truncated weighting: the response rows (4, M, S, block) and the
    # banded k_t of the WEIGHTING_TAPS-tap kernels of random weighting
    # curves, as the hop builds them (B = 160 at block 1600).
    taps8, b8 = WEIGHTING_TAPS, 160
    x8 = rnd(4, m, s, block)
    kern8 = weighting_kernel(0.5 + rnd(2, m, cfg.num_bins).abs(), block, taps8,
                             plan.idft_cos_plain)
    k8 = _banded_toeplitz_t(kern8, b8, taps8).contiguous()
    u8 = b8 + taps8 - 1
    # The library yardstick: a depthwise convolution of the circularly
    # padded rows, each with its zone's kernel (flipped: conv1d correlates).
    h8 = taps8 // 2
    conv8_in = F.pad(x8.reshape(1, 4 * m * s, block), (h8, h8), mode="circular")
    conv8_w = kern8.flip(-1)[[0, 1, 0, 1]][:, :, None].expand(4, m, s, taps8)
    conv8_w = conv8_w.reshape(4 * m * s, 1, taps8).contiguous()

    cases = [
        dict(
            name="streaming_conv", route="cuda",
            source="apvast_torch/csrc/streaming_conv.cu",
            replaces="apvast_tpu/ops/pallas/streaming_conv.py:53",
            kernel=lambda: K.streaming_conv(seg, kern, hop),
            plain=lambda: K.streaming_conv_plain(seg, kern, hop),
            # The one call that computes K1's function: cuBLAS on a window view.
            library=lambda: kern @ seg.unfold(-1, hop, 1)[:, hist - taps + 1 : hist + 1].flip(1),
            context={"conv1d_ms": lambda: F.conv1d(conv_in, conv_w, groups=2)},
            oracle=[("north star", lambda a, b: K.streaming_conv(a, b, hop),
                     lambda a, b: K.streaming_conv_plain(a, b, hop), (seg, kern))],
            flops=2 * 2 * rows * taps * hop,
            tc_flops=2 * 2 * rows * taps * hop,
            bytes=4 * (seg.numel() + kern.numel() + 2 * rows * hop),
            ragged=[
                (lambda a, b: K.streaming_conv(a, b, 50),
                 lambda a, b: K.streaming_conv_plain(a, b, 50),
                 (rnd(2, 300), rnd(2, 37, 77))),
            ],
        ),
        dict(
            name="lag_corr", route="cuda",
            source="apvast_torch/csrc/lag_corr.cu",
            replaces="apvast_tpu/ops/pallas/lag_corr.py:60",
            kernel=lambda: K.lag_corr(x2, j),
            plain=lambda: K.lag_corr_plain(x2, j),
            library=lambda: F.conv1d(c0_in, c0_w, groups=4),
            flops=2 * 4 * m * (s + 1) ** 2 * j * k2,
            bytes=4 * (x2.numel() + 4 * (s + 1) ** 2 * j),
            ragged=[
                (lambda a: K.lag_corr(a, 9), lambda a: K.lag_corr_plain(a, 9),
                 (rnd(4, 3, 5, 70),)),
                (lambda a: K.lag_corr(a, 40), lambda a: K.lag_corr_plain(a, 40),
                 (rnd(4, 2, 33, 120),)),
            ],
        ),
        dict(
            name="skew_assembly", route="cuda",
            source="apvast_torch/csrc/skew_assembly.cu",
            replaces="apvast_tpu/ops/pallas/skew_assembly.py:118",
            # The main path's form is the half form; the full form (the
            # exact path's) is checked and timed beside it.
            kernel=lambda: K.lag_skew_assemble(lhs3, rhs3, c03, j, half_scaled=True),
            plain=lambda: K.lag_skew_assemble_plain(lhs3, rhs3, c03, j, half_scaled=True),
            library=None,
            flops=2 * 4 * (j * s) * (2 * m) * (s * j),
            bytes=4 * (lhs3.numel() + rhs3.numel() + c03.numel() + 4 * s * j * s * j),
            ragged=[
                (lambda a, b, c, hf=hf: K.lag_skew_assemble(a, b, c, 9, half_scaled=hf),
                 lambda a, b, c, hf=hf: K.lag_skew_assemble_plain(a, b, c, 9, half_scaled=hf),
                 (rnd(4, 9 * 5, 6), rnd(4, 6, 5 * 9), rnd(4, 5, 5 * 9)))
                for hf in (False, True)
            ] + [
                (lambda a, b, c: K.lag_skew_assemble(a, b, c, 3, half_scaled=True),
                 lambda a, b, c: K.lag_skew_assemble_plain(a, b, c, 3, half_scaled=True),
                 (rnd(2, 33 * 3, 4), rnd(2, 4, 33 * 3), rnd(2, 33, 99))),
            ],
            extra=[
                dict(label="full_form",
                     kernel=lambda: K.lag_skew_assemble(lhs3, rhs3, c03, j),
                     plain=lambda: K.lag_skew_assemble_plain(lhs3, rhs3, c03, j)),
            ],
        ),
        dict(
            name="whiten", route="cuda",
            source="apvast_torch/csrc/whiten.cu",
            replaces="apvast_tpu/ops/pallas/whiten.py:204",
            kernel=lambda: K.chol_panel(panel),
            plain=lambda: K.chol_panel_plain(panel),
            library=None,
            # Context: the library factorization and inverse of the same batch.
            context={"context_ms": lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky_ex(panel)[0], eye128.expand(2, 128, 128), upper=False)},
            # Per panel n^3 / 3 flops for the factor and n^3 / 3 for its
            # triangular inverse; the panel read once, both factors written.
            flops=2 * 2 * 128**3 // 3,
            bytes=4 * 3 * 2 * 128 * 128,
            ragged=[
                (K.chol_panel, K.chol_panel_plain, (spd(1, 128),)),
                (K.chol_panel, K.chol_panel_plain, (spd(3, 128),)),
            ],
        ),
        dict(
            name="subspace", route="cuda",
            source="apvast_torch/csrc/subspace.cu",
            replaces="apvast_tpu/ops/pallas/subspace.py:130",
            kernel=lambda: K.subspace_iterate(a9, li9, q9, 2),
            plain=lambda: K.subspace_iterate_plain(a9, li9, q9, 2),
            library=None,
            # Context: the unfused 'invert' chain of the solver (power steps
            # with CholeskyQR2, and the projection) on the same inputs.
            context={"context_ms": lambda: _topk_project(a9, a9, 0.0, 2, q9, "cholqr2",
                                                          "invert", li9)},
            # Per pencil (iters + 1) applications of Li A Li^T, 4 n^2 k flops
            # (Li triangular), and (4 iters + 1) n k^2 for the symmetric Grams
            # and triangular L^-T products; a, li read and q0, q written once.
            flops=2 * (3 * 4 * jl * jl * k9 + 9 * jl * k9 * k9),
            bytes=4 * 2 * (2 * jl * jl + 2 * jl * k9),
            ragged=[
                (lambda a, b, c: K.subspace_iterate(a, b, c, 2),
                 lambda a, b, c: K.subspace_iterate_plain(a, b, c, 2), r200),
            ],
        ),
        dict(
            name="jacobi_eigh", route="cuda",
            source="apvast_torch/csrc/jacobi_eigh.cu",
            replaces="apvast_tpu/ops/pallas/jacobi_eigh.py:158",
            kernel=lambda: K.jacobi_eigh(h_warm, 2),
            plain=lambda: K.jacobi_eigh_plain(h_warm, 2),
            library=lambda: torch.linalg.eigh(h_warm),
            # Per round: 6 flops per entry of A (two 2-term combinations),
            # 3 per entry of V; (npad - 1) rounds per sweep.
            flops=2 * 2 * (npad - 1) * 9 * npad * npad,
            bytes=4 * (2 * k4 * k4 + 2 * k4 * k4 + 2 * k4),
            ragged=[
                (lambda a: K.jacobi_eigh(a, 2), lambda a: K.jacobi_eigh_plain(a, 2),
                 (_warm(g, dev, 3, 10),)),
                (lambda a: K.jacobi_eigh(a, 2), lambda a: K.jacobi_eigh_plain(a, 2),
                 (_warm(g, dev, 5, 37),)),
            ],
            extra=[
                dict(label="cold_8_sweeps", up_to_sign=True,
                     kernel=lambda: K.jacobi_eigh(h_cold, 8),
                     plain=lambda: K.jacobi_eigh_plain(h_cold, 8)),
            ],
        ),
        dict(
            name="jacobi_eigh_hermitian", route="cuda",
            source="apvast_torch/csrc/jacobi_eigh.cu",
            replaces="apvast_tpu/ops/pallas/jacobi_eigh.py:262",
            kernel=lambda: K.jacobi_eigh_hermitian(h7, FD_SWEEPS),
            plain=lambda: K.jacobi_eigh_hermitian_plain(h7, FD_SWEEPS),
            library=lambda: torch.linalg.eigh(h7),
            # Eigenvalues only: the eigenvectors carry a phase that rounding
            # picks (_hermitian_checks holds them).
            compare=lambda got, want: [_rel(got[0], want[0])],
            # K4's count on the 2S-slot embedding; complex input read once,
            # w and q written once.
            flops=2 * bins * FD_SWEEPS * (np7 - 1) * 9 * np7 * np7,
            bytes=8 * h7.numel() + 4 * 2 * bins * s + 8 * h7.numel(),
            ragged=[
                (lambda a: K.jacobi_eigh_hermitian(a, FD_SWEEPS),
                 lambda a: K.jacobi_eigh_hermitian_plain(a, FD_SWEEPS),
                 (_hermitian(g, dev, 3, 5),)),
            ],
            extra=[
                dict(label="frame_taps_2",
                     kernel=lambda: K.jacobi_eigh_hermitian(h7b, FD_SWEEPS),
                     plain=lambda: K.jacobi_eigh_hermitian_plain(h7b, FD_SWEEPS)),
            ],
        ),
        dict(
            name="output_filter", route="cuda",
            source="apvast_torch/csrc/output_filter.cu",
            replaces="apvast_tpu/ops/pallas/output_filter.py:72",
            kernel=lambda: K.circular_filter_overlap(x5, f5, plan.window, t5, hop),
            plain=lambda: K.circular_filter_overlap_plain(x5, f5, plan.window, t5, hop),
            library=lambda: F.conv1d(ext5, w5, groups=2),
            flops=2 * 2 * v * s * j * block,
            bytes=4 * (x5.numel() + f5.numel() + block + t5.numel()
                       + 2 * v * s * hop + t5.numel()),
            ragged=[
                (lambda a, b, w, t: K.circular_filter_overlap(a, b, w, t, 30),
                 lambda a, b, w, t: K.circular_filter_overlap_plain(a, b, w, t, 30),
                 (rnd(2, 100), rnd(2, 37, 9), rnd(100), rnd(2, 37, 70))),
                (lambda a, b, w, t: K.circular_filter_overlap(a, b, w, t, 60),
                 lambda a, b, w, t: K.circular_filter_overlap_plain(a, b, w, t, 60),
                 (rnd(2, 100), rnd(2, 37, 9), rnd(100), rnd(2, 37, 40))),
            ],
        ),
        dict(
            name="statistics", route="cuda",
            source="apvast_torch/csrc/statistics.cu",
            replaces="apvast_tpu/ops/pallas/statistics.py:396",
            kernel=lambda: K.covariance(buf6, tgt6, j),
            plain=lambda: K.covariance_plain(buf6, tgt6, j),
            # No single PyTorch call computes K6: the port's own dense path
            # (unfold + cuBLAS einsums) is the yardstick.
            library=lambda: framed_statistics(buf6, tgt6, j),
            oracle=[("north star", lambda a, b: K.covariance(a, b, j),
                     lambda a, b: K.covariance_plain(a, b, j), (buf6, tgt6)),
                    ("sj_1600", lambda a, b: K.covariance(a, b, j),
                     lambda a, b: K.covariance_plain(a, b, j), (buf6w, tgt6))],
            # The symmetric Gram counted as half (on the tensor cores), and the
            # cross vector (fp32 FMA).
            flops=2 * 4 * m * (sj * (sj + 1) // 2 + 2 * sj) * k6,
            tc_flops=2 * 4 * m * (sj * (sj + 1) // 2) * k6,
            bytes=4 * (buf6.numel() + tgt6.numel() + 4 * sj * sj + 4 * sj * 2),
            ragged=[
                (lambda a, b: K.covariance(a, b, 100), lambda a, b: K.covariance_plain(a, b, 100),
                 (rnd(2, 2, 3, 200), rnd(2, 2, 101))),
                (lambda a, b: K.covariance(a, b, 8), lambda a, b: K.covariance_plain(a, b, 8),
                 (rnd(4, 3, 4, 96), rnd(2, 3, 89))),
            ],
            extra=[
                dict(label="sj_1600",
                     kernel=lambda: K.covariance(buf6w, tgt6, j),
                     plain=lambda: K.covariance_plain(buf6w, tgt6, j)),
            ],
        ),
        dict(
            name="rowwise_conv", route="cuda",
            source="apvast_torch/csrc/rowwise_conv.cu",
            replaces="apvast_tpu/ops/pallas/rowwise_conv.py:44",
            kernel=lambda: K.rowwise_circular_conv(x8, k8, taps8, b8),
            plain=lambda: K.rowwise_circular_conv_plain(x8, k8, taps8, b8),
            library=lambda: F.conv1d(conv8_in, conv8_w, groups=4 * m * s),
            # Every frame over its full depth U = B + T - 1, as the TPU kernel.
            flops=2 * 4 * m * s * block * u8,
            bytes=4 * (2 * x8.numel() + k8.numel()),
            ragged=[
                (lambda a, b: K.rowwise_circular_conv(a, b, 9, 16),
                 lambda a, b: K.rowwise_circular_conv_plain(a, b, 9, 16),
                 (rnd(4, 2, 3, 64), rnd(2, 2, 16, 24))),
                (lambda a, b: K.rowwise_circular_conv(a, b, 7, 48),
                 lambda a, b: K.rowwise_circular_conv_plain(a, b, 7, 48),
                 (rnd(4, 2, 17, 96), rnd(2, 2, 48, 54))),
            ],
        ),
        dict(
            name="chol_tri_inverse", route="cuda",
            source="apvast_torch/csrc/chol_tri_inverse.cu",
            replaces="apvast_tpu/ops/pallas/whiten.py:387",
            kernel=lambda: K.chol_tri_inverse(b10),
            plain=lambda: K.chol_tri_inverse_plain(b10),
            library=None,
            # No single PyTorch call computes L^-1: two chains for context,
            # (a) the library's, (b) what the invert path runs today.
            context={
                "chain_a_ms": lambda: torch.linalg.solve_triangular(
                    torch.linalg.cholesky_ex(b10)[0], eye_jl.expand(2, jl, jl), upper=False),
                "chain_b_ms": lambda: triangular_inverse(K.blocked_cholesky(b10)),
            },
            tol=TOL_CHOL_TRI,
            # Per matrix n^3 / 3 flops for the factor and n^3 / 3 for its
            # triangular inverse; b read once, X written once.
            flops=2 * 2 * jl**3 // 3,
            bytes=4 * 2 * 2 * jl * jl,
            ragged=[
                (K.chol_tri_inverse, K.chol_tri_inverse_plain, (b10_200,)),
                (K.chol_tri_inverse, K.chol_tri_inverse_plain, (b10_1024,)),
            ],
        ),
        dict(
            name="circular_filter", route="cuda",
            source="apvast_torch/csrc/output_filter.cu",
            replaces="apvast_tpu/ops/pallas/output_filter.py:165",
            kernel=lambda: K.circular_filter(x5, f5),
            plain=lambda: K.circular_filter_plain(x5, f5),
            library=lambda: F.conv1d(ext5, w5, groups=2),
            flops=2 * 2 * v * s * j * block,
            bytes=4 * (x5.numel() + f5.numel() + 2 * v * s * block),
            ragged=[
                (K.circular_filter, K.circular_filter_plain, (rnd(2, 100), rnd(2, 37, 9))),
                (K.circular_filter, K.circular_filter_plain, (x5, rnd(2, 1000, 9))),
            ],
        ),
    ]

    _whiten_conditioning(K, spd, eye128)
    _chol_tri_inverse_checks(K, spd, [b10, b10_200, b10_1024], card)
    wide_ms = _jacobi_wide_checks(K, g, dev, card, flush)
    _jacobi_on_invert_hops(scene, dev, card)
    _hermitian_checks(K, [
        ("frame_taps_1", h7, FD_SWEEPS), ("frame_taps_2", h7b, FD_SWEEPS),
        ("ragged", _hermitian(g, dev, 3, 5), FD_SWEEPS),
        ("degenerate_pairs", _degenerate_pairs(dev), 10),
    ], card)
    _hermitian_against_k4(K, [("frame_taps_1", h7), ("frame_taps_2", h7b)], card)
    _rowwise_checks(K, x8, k8, taps8, b8, card)
    for c in cases:
        cmp = c.get("compare", _errs)
        errs = cmp(c["kernel"](), c["plain"]())
        torch.cuda.synchronize()
        max_abs = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        tol = c.get("tol", TOL_KERNEL)
        _check(c["name"] + " (north-star shape)", rel, tol)
        for kfn, pfn, args in c["ragged"]:
            shapes = [tuple(a.shape) for a in args]
            for _, r in cmp(kfn(*args), pfn(*args)):
                _check(f"{c['name']} (ragged {shapes})", r, tol)
        if "oracle" in c:
            _oracle_checks(c["name"], c["oracle"] + [
                (f"ragged {[tuple(a.shape) for a in args]}", kfn, pfn, args)
                for kfn, pfn, args in c["ragged"]], card)
        extra_ms = {}
        for x in c.get("extra", []):
            if x.get("up_to_sign"):
                x_errs = _errs(x["kernel"](), x["plain"](), True)
            else:
                x_errs = cmp(x["kernel"](), x["plain"]())
            x_rel = max(e[1] for e in x_errs)
            _check(f"{c['name']} ({x['label']})", x_rel, TOL_KERNEL)
            x_ms = _time_ms(x["kernel"], 50, flush)
            extra_ms["ms_" + x["label"]] = x_ms
            print(f"[phase 2] {c['name']} {x['label']}: rel_err={x_rel:.3e} "
                  f"max_abs_err={max(e[0] for e in x_errs):.3e} "
                  f"kernel_ms={x_ms:.5f} card={card}", flush=True)
        kernel_ms = _time_ms(c["kernel"], 50, flush)
        plain_ms = _time_ms(c["plain"], 10, flush)
        library_ms = _time_ms(c["library"], 50, flush) if c["library"] else None
        for key, fn in c.get("context", {}).items():
            extra_ms[key] = _time_ms(fn, 50, flush)
            print(f"[phase 2] {c['name']}: {key} (see the docstring) "
                  f"{extra_ms[key]:.5f} ms card={card}", flush=True)
        t_ops = c["flops"] / PEAK_FP32_FLOPS * 1e3
        t_bytes = c["bytes"] / PEAK_BYTES * 1e3
        simt = ""
        if "tc_flops" in c:
            # 3xTF32: three TF32 passes on the tensor cores, the rest fp32 FMA.
            extra_ms["bound_fp32_ms"] = max(t_ops, t_bytes)
            simt = (f"bound_fp32_us={extra_ms['bound_fp32_ms'] * 1e3:.2f} "
                    f"fp32_share={extra_ms['bound_fp32_ms'] / kernel_ms:.3f} ")
            t_ops = (3 * c["tc_flops"] / PEAK_TF32_FLOPS
                     + (c["flops"] - c["tc_flops"]) / PEAK_FP32_FLOPS) * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(
            f"[phase 2] {c['name']}: rel_err={rel:.3e} max_abs_err={max_abs:.3e} "
            f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
            f"library_ms={library_ms if library_ms is None else f'{library_ms:.5f}'} "
            f"bound_us={bound_ms * 1e3:.2f} ({bound_by}) "
            f"roofline_share={bound_ms / kernel_ms:.3f} {simt}card={card}",
            flush=True,
        )
        results.append(dict(
            name=c["name"], route=c["route"], source=c["source"],
            replaces=c["replaces"], launches=0, max_abs_err=max_abs,
            ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, **extra_ms,
            **wide_ms.get(c["name"], {}),
        ))
    return results


def _whiten_conditioning(K, spd, eye):
    """K10a on an ill-conditioned panel (a 1e5 rank-one boost): its whitening
    residual max |X d X^T - I| within twice that of cholesky_ex +
    solve_triangular (plus 1e-5), as tests/test_whiten_kernel.py holds the
    TPU kernel; and a panel with a negative pivot gives non-finite output."""
    d = spd(2, 128, boost=1e5)
    _, x = K.chol_panel(d)
    ref = torch.linalg.solve_triangular(
        torch.linalg.cholesky_ex(d)[0], eye.expand(2, 128, 128), upper=False)

    def residual(x):
        x = x.double()
        return float((x @ d.double() @ x.transpose(1, 2) - eye.double()).abs().max())

    res, res_ref = residual(x), residual(ref)
    print(f"[phase 2] whiten ill-conditioned panel: whitening residual {res:.3e}, "
          f"cholesky_ex + solve_triangular {res_ref:.3e}", flush=True)
    if not res <= 2.0 * res_ref + 1e-5:
        raise AssertionError(f"whiten: residual {res:.3e} > 2 x {res_ref:.3e} + 1e-5")
    bad = spd(2, 128)
    bad[1, 70, 70] = -1.0
    l, x = K.chol_panel(bad)
    torch.cuda.synchronize()
    if torch.isfinite(l[1]).all() or torch.isfinite(x[1]).all() or not torch.isfinite(l[0]).all():
        raise AssertionError("whiten: a non-PD panel must give non-finite output, a PD one finite")
    print("[phase 2] whiten non-PD panel: non-finite factor and inverse (PD panel beside it "
          "finite)", flush=True)


def _chol_tri_inverse_checks(K, spd, batches, card):
    """K10b against a float64 oracle (cholesky, then solve_triangular) at
    each of ``batches``, within TOL_CHOL_TRI of scale and with exact zeros
    above the diagonal; on an ill-conditioned (2, 800, 800) batch (a 1e5
    rank-one boost) its whitening residual max |X B X^T - I| within twice
    that of cholesky_ex + solve_triangular (plus 1e-5), as
    tests/test_whiten_kernel.py holds the TPU kernel; and a non-PD matrix
    gives non-finite output while the PD one beside it stays finite."""
    for b in batches:
        x = K.chol_tri_inverse(b)
        n = b.shape[-1]
        eye = torch.eye(n, dtype=torch.float64, device=b.device)
        ref = torch.linalg.solve_triangular(torch.linalg.cholesky(b.double()),
                                            eye.expand(b.shape[0], n, n), upper=False)
        diff, rel = _rel(x, ref)
        upper = float(torch.triu(x, 1).abs().max())
        print(f"[phase 2] chol_tri_inverse {tuple(b.shape)} against float64: rel_err={rel:.3e} "
              f"max_abs_err={diff:.3e}, max |upper| {upper}", flush=True)
        _check(f"chol_tri_inverse {tuple(b.shape)} against float64", rel, TOL_CHOL_TRI)
        if upper != 0.0:
            raise AssertionError("chol_tri_inverse: nonzero entries above the diagonal")
    n = batches[0].shape[-1]
    b = spd(2, n, boost=1e5)
    eye = torch.eye(n, device=b.device)
    x = K.chol_tri_inverse(b)
    chain = torch.linalg.solve_triangular(torch.linalg.cholesky_ex(b)[0], eye.expand(2, n, n),
                                          upper=False)

    def residual(x):
        x = x.double()
        return float((x @ b.double() @ x.transpose(1, 2) - eye.double()).abs().max())

    res, res_ref = residual(x), residual(chain)
    print(f"[phase 2] chol_tri_inverse ill-conditioned (2, {n}, {n}): whitening residual "
          f"{res:.3e}, cholesky_ex + solve_triangular {res_ref:.3e}", flush=True)
    if not res <= 2.0 * res_ref + 1e-5:
        raise AssertionError(f"chol_tri_inverse: residual {res:.3e} > 2 x {res_ref:.3e} + 1e-5")
    bad = spd(2, n)
    bad[1, 300, 300] = -1.0
    x = K.chol_tri_inverse(bad)
    torch.cuda.synchronize()
    if torch.isfinite(x[1]).all() or not torch.isfinite(x[0]).all():
        raise AssertionError("chol_tri_inverse: a non-PD matrix must give non-finite output, "
                             "a PD one finite")
    print(f"[phase 2] chol_tri_inverse non-PD matrix: non-finite output (PD matrix beside it "
          f"finite) card={card}", flush=True)


def _jacobi_wide_checks(K, g, dev, card, flush):
    """K4 and K7 past 128 slots (the single-buffered 512-thread form up to
    160 slots, the global-memory form above), WIDE_SWEEPS sweeps on
    WIDE_JACOBI against their plain versions: the eigenvalues to TOL_KERNEL
    of scale; the eigenvectors, whose close pairs carry the rounding of
    ~1600 rounds, by the residual max |A v - v w| / max |A| and max
    |V^H V - I|, within the larger of TOL_KERNEL and HERM_RATIO x the plain
    version's. Warm-start-like inputs (a spread diagonal and a small
    perturbation): eight cold sweeps leave close pairs of a random 144-slot
    matrix unconverged on either device, so that rounding picks them.
    Returns each wrapper's times, {name: {ms_<label>: ms}}."""
    out = {"jacobi_eigh": {}, "jacobi_eigh_hermitian": {}}
    for bz, n, complex_ in WIDE_JACOBI:
        if complex_:
            a, fn, plain = _warm_hermitian(g, dev, bz, n), K.jacobi_eigh_hermitian, \
                K.jacobi_eigh_hermitian_plain
            slots = -(-2 * n // 8) * 8
        else:
            a, fn, plain = _warm(g, dev, bz, n), K.jacobi_eigh, K.jacobi_eigh_plain
            slots = -(-n // 8) * 8
        w, v = fn(a, WIDE_SWEEPS)
        wp, vp = plain(a, WIDE_SWEEPS)
        torch.cuda.synchronize()
        d_rel = _rel(w, wp)[1]
        ac = a if complex_ else a.to(torch.complex64)
        got = [float(x.max()) for x in _hermitian_state(ac, w, v.to(ac.dtype))]
        want = [float(x.max()) for x in _hermitian_state(ac, wp, vp.to(ac.dtype))]
        label = f"{'complex_' if complex_ else ''}{bz}x{n}_{slots}_slots"
        ms = _time_ms(lambda: fn(a, WIDE_SWEEPS), 5, flush)
        plain_ms = _time_ms(lambda: plain(a, WIDE_SWEEPS), 2, flush)
        out[fn.__name__][f"ms_{label}"] = ms
        out[fn.__name__][f"plain_ms_{label}"] = plain_ms
        print(f"[phase 2] {fn.__name__} {label}, {WIDE_SWEEPS} sweeps: eigenvalues "
              f"rel_err={d_rel:.3e}; residual {got[0]:.3e} (plain {want[0]:.3e}); max "
              f"|V^H V - I| {got[1]:.3e} (plain {want[1]:.3e}); kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} card={card}", flush=True)
        _check(f"{fn.__name__} {label} eigenvalues", d_rel, TOL_KERNEL)
        for name, x, xp in zip(("residual", "orthonormality"), got, want):
            limit = max(TOL_KERNEL, HERM_RATIO * xp)
            if not x <= limit:
                raise AssertionError(f"{fn.__name__} {label}: {name} {x:.3e} > {limit:.3e}")
    return out


def _inputs(scene):
    """The seeded initial response noise and the (2, HOPS * hop) program
    signals of every phase-3 path."""
    cfg = scene.config
    m, s, block = cfg.num_mics, cfg.num_srcs, cfg.block_size
    rng = np.random.default_rng(SEED)
    noise = (
        1e-3 * rng.standard_normal((4, m, s, block)),
        1e-3 * rng.standard_normal((2, m, block)),
    )
    return noise, rng.standard_normal((2, HOPS * cfg.hop)).astype(np.float32)


def _jacobi_state(h, d, v):
    """In float64, per matrix: the off-diagonal remainder ||off(V^T h V)||
    over ||h|| (Frobenius); and over the batch: |sorted diag(V^T h V) - d|
    over max |d|, and max |V^T V - I|."""
    h, d, v = h.double(), d.double(), v.double()
    a = v.transpose(1, 2) @ h @ v
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    off = (a - torch.diag_embed(diag)).norm(dim=(-2, -1)) / h.norm(dim=(-2, -1))
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    return (off, _rel(torch.sort(diag, -1)[0], d)[1],
            float((v.transpose(1, 2) @ v - eye).abs().max()))


def _jacobi_on_invert_hops(scene, dev, card):
    """K4 at the invert path's sweeps on its own Rayleigh-Ritz matrices:
    those of the path's first WITNESS_HOPS hops on the card (phase 3's
    input), captured where the solver calls K4. These matrices are far from
    diagonal, and where two diagonal entries are close a rounding-sized
    change picks the other of two +-45 degree rotations, so the unconverged
    eigenvectors of the plain version itself move by O(1) under ULP_REL
    changes of the input (reported, the most of 3 draws). What does not
    move is held: the eigenvalues against the plain version's (TOL_KERNEL),
    the kernel's eigenvalues against the diagonal of V^T h V and V's
    orthonormality (TOL_KERNEL), and its off-diagonal remainder within
    JACOBI_REMAINDER times the plain version's on every matrix (one sweep
    fewer leaves 3-8 times as much)."""
    from apvast_torch import production_overrides
    from apvast_torch.ops import jdiag
    from apvast_torch.ops import kernels as K

    noise, sig = _inputs(scene)
    model = _model(scene, dev, noise, production_overrides() | INVERT)
    sig = torch.as_tensor(sig).to(dev).reshape(2, HOPS, -1)
    captured = []
    solve = jdiag.jacobi_eigh
    jdiag.jacobi_eigh = lambda h, sweeps: (captured.append(h.clone()), solve(h, sweeps))[1]
    try:
        for i in range(WITNESS_HOPS):
            model.process_input_buffers(sig[0, i], sig[1, i])
    finally:
        jdiag.jacobi_eigh = solve
    h = torch.cat(captured)
    sweeps = INVERT["jacobi_sweeps"]
    got, want = K.jacobi_eigh(h, sweeps), K.jacobi_eigh_plain(h, sweeps)
    (_, d_rel), (_, v_rel) = _errs(got, want)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    spread = 0.0
    for _ in range(3):
        hp = h * (1 + ULP_REL * torch.randn(h.shape, generator=g).to(dev))
        spread = max(spread, _errs(K.jacobi_eigh_plain((hp + hp.transpose(1, 2)) / 2,
                                                       sweeps), want)[1][1])
    off, consistency, orth = _jacobi_state(h, *got)
    off_plain = _jacobi_state(h, *want)[0]
    ratio = float((off / off_plain).max())
    print(f"[phase 2] jacobi_eigh, {sweeps} sweeps, on the invert path's Rayleigh-Ritz "
          f"matrices {tuple(h.shape)} (hops 1-{WITNESS_HOPS}): eigenvalues rel_err={d_rel:.3e}; "
          f"eigenvalues against diag(V^T h V) {consistency:.3e}; max |V^T V - I| {orth:.3e}; "
          f"off-diagonal remainder {[round(x, 5) for x in off.tolist()]}, plain "
          f"{[round(x, 5) for x in off_plain.tolist()]} (most {ratio:.3f} x); eigenvectors "
          f"rel_err={v_rel:.3e}, the plain version's own under {ULP_REL:.0e} input changes "
          f"{spread:.3e} (reported) card={card}", flush=True)
    _check("jacobi_eigh on the invert hops, eigenvalues", d_rel, TOL_KERNEL)
    _check("jacobi_eigh on the invert hops, eigenvalues against V^T h V", consistency, TOL_KERNEL)
    _check("jacobi_eigh on the invert hops, orthonormality", orth, TOL_KERNEL)
    if not ratio <= JACOBI_REMAINDER:
        raise AssertionError(f"jacobi_eigh on the invert hops: off-diagonal remainder "
                             f"{ratio:.3f} x the plain version's > {JACOBI_REMAINDER}")


def _model(scene, device, noise, overrides):
    from apvast_torch import ApVast

    c = scene.config
    return ApVast(
        c.block_size, scene.rir_a, scene.rir_b, c.filter_length,
        c.modeling_delay, c.reference_index_a, c.reference_index_b,
        c.num_eigenvectors, c.mu, c.statistics_buffer_length,
        sampling_rate=c.sampling_rate, perceptual=c.perceptual,
        device=device, response_noise=noise, **overrides,
    )


def _to(state, device):
    """A copy of a hop state on ``device``."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(device)
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
    })


def _compare(label, name, got, want, tol):
    rel = _rel(got, want)[1]
    print(f"[phase 3] {label} {name}: rel_err={rel:.3e}", flush=True)
    _check(f"{label} {name}", rel, tol)


def _contrast(scene, tail_a):
    """Zone-A acoustic contrast (dB) of each rank's tail feeds."""
    from apvast_torch.evaluation import acoustic_contrast_db, predict_pressure

    feeds = torch.cat(tail_a, dim=1).double()  # (ranks, T, srcs)
    bright = predict_pressure(feeds, scene.rir_a)
    dark = predict_pressure(feeds, scene.rir_b)
    return [float(x) for x in acoustic_contrast_db(bright, dark)]


def _compare_with_cpu(scene, label, cfg, overrides, noise, states, outs, hops_a, hops_b,
                      gate_feeds=True):
    """The first CPU_HOPS hops through the port on the CPU (plain versions):
    from the card's state hop by hop under a subspace solver (unconverged
    Jacobi sweeps make a free-running stream drift), free-running under the
    exact one. Statistics to TOL_STATS, target feeds to TOL_TARGET and
    loudspeaker feeds to TOL_FEEDS (only printed unless ``gate_feeds``)."""
    from apvast_torch.config import uses_subspace_solver
    from apvast_torch.engine import build_plan, hop_statistics, process_hop
    from apvast_torch.engine.hop import half_form

    t2 = time.perf_counter()
    if uses_subspace_solver(cfg):
        plan = build_plan(cfg, scene.rir_a, scene.rir_b, "cpu")
        cpu_outs = []
        worst = {}
        for i in range(CPU_HOPS):
            cpu_state, o = process_hop(cfg, plan, _to(states[i], "cpu"), hops_a[i], hops_b[i])
            cpu_outs.append((o.out_a, o.out_b, o.out_a_t, o.out_b_t))
            for name, a, b in zip(
                ("M" if half_form(cfg) else "R", "r"),
                hop_statistics(cfg, states[i + 1].wresp_stat, states[i + 1].wtarget_stat),
                hop_statistics(cfg, cpu_state.wresp_stat, cpu_state.wtarget_stat),
            ):
                rel = _rel(a.cpu(), b)[1]
                worst[name] = max(worst.get(name, 0.0), rel)
                _check(f"{label} hop {i + 1} statistics {name}", rel, TOL_STATS)
        print(f"[phase 3] {label}: statistics of hops 1-{CPU_HOPS} within "
              f"{TOL_STATS:.0e} of the CPU: worst rel_err "
              f"{ {name: f'{x:.2e}' for name, x in worst.items()} }", flush=True)
    else:
        cpu = _model(scene, "cpu", noise, overrides)
        cpu_outs = [cpu.process_input_buffers(hops_a[i], hops_b[i]) for i in range(CPU_HOPS)]
        for name, a, b in zip(
            ("R", "r"),
            hop_statistics(cfg, states[-1].wresp_stat, states[-1].wtarget_stat),
            hop_statistics(cfg, cpu.state.wresp_stat, cpu.state.wtarget_stat),
        ):
            _compare(label, f"hop {CPU_HOPS} statistics {name}", a.cpu(), b, TOL_STATS)
    for f, name in enumerate(("out_a", "out_b", "out_a_t", "out_b_t")):
        g = torch.stack([o[f] for o in outs]).cpu()
        c = torch.stack([o[f].expand_as(g[0]) for o in cpu_outs])
        per_hop = [f"{_rel(g[i], c[i])[1]:.1e}" for i in range(CPU_HOPS)]
        target = name.endswith("_t")
        gated = target or gate_feeds
        print(f"[phase 3] {label} {name} vs CPU, hops 1-{CPU_HOPS}: per hop {per_hop}"
              f"{'' if gated else f', all {_rel(g, c)[1]:.1e} (not gated)'}", flush=True)
        if gated:
            _check(f"{label} {name} vs CPU", _rel(g, c)[1], TOL_TARGET if target else TOL_FEEDS)
    print(f"[phase 3] {label}: CPU comparison took {time.perf_counter() - t2:.1f} s", flush=True)


def _run_hops(model, label, sig, dev, hops, want_counts, card, per_hop):
    """``hops`` hops of ``model`` on the card from the program signals
    ``sig``: the launch counts against ``want_counts``, ``silenced == 0``,
    every output's shape (ranks, hop, srcs) and finiteness, and the host
    time of the first CPU_HOPS hops and of the rest (the steady state).
    ``per_hop(i, out)`` runs after each hop. Returns the CPU input hops, the
    states and outputs of the first CPU_HOPS hops, the counts and the
    steady-state ms/hop (None without a steady-state window)."""
    from apvast_torch.ops import kernels as K

    cfg = model.config
    hops_a = torch.as_tensor(sig[0][: hops * cfg.hop]).reshape(hops, cfg.hop)
    hops_b = torch.as_tensor(sig[1][: hops * cfg.hop]).reshape(hops, cfg.hop)
    hops_a_dev, hops_b_dev = hops_a.to(dev), hops_b.to(dev)
    torch.cuda.synchronize()

    K.reset_launch_counts()
    states, outs = [model.state], []
    t_first = t0 = time.perf_counter()
    for i in range(hops):
        if i == CPU_HOPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = model.process_input_buffers(hops_a_dev[i], hops_b_dev[i])
        if i < CPU_HOPS:
            outs.append(out)
            states.append(model.state)
        per_hop(i, out)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = K.launch_counts()
    print(f"[phase 3] {label}: launches over {hops} hops: {counts}", flush=True)
    if counts != want_counts:
        raise AssertionError(f"{label}: launches {counts}, want {want_counts}")
    silenced = int(model.silenced.item())
    if silenced != 0:
        raise AssertionError(f"{label}: silenced = {silenced}")
    ranks = out[0].shape[0]
    for out in (*outs, out):
        for t in out:
            if tuple(t.shape) != (ranks, cfg.hop, cfg.num_srcs) or not torch.isfinite(t).all():
                raise AssertionError(f"{label}: bad output, shape {tuple(t.shape)}")
    first = min(hops, CPU_HOPS)
    first_s = (t0 if hops > CPU_HOPS else t1) - t_first
    ms_hop = (t1 - t0) / (hops - CPU_HOPS) * 1e3 if hops > CPU_HOPS else None
    steady = (f"steady state {ms_hop:.3f} ms/hop over hops {CPU_HOPS + 1}-{hops}"
              if ms_hop is not None else "no steady-state window")
    print(f"[phase 3] {label}: scale_scene(16), {hops} hops, {ranks} output ranks, silenced=0, "
          f"first {first} hops {first_s * 1e3 / first:.3f} ms/hop, {steady} (host clock, "
          f"synchronized) card={card}", flush=True)
    return hops_a, hops_b, hops_a_dev, hops_b_dev, states, outs, counts, ms_hop


def drive(scene, dev, card, label, overrides, want_counts, sig, noise, hops=None,
          gate_feeds=True):
    """``hops`` (default HOPS) hops of one configuration on the card: launch
    counts, health, steady-state time (``_run_hops``), the first CPU_HOPS
    hops against the CPU (the loudspeaker feeds only printed unless
    ``gate_feeds``), and the zone-A tail feeds at rank 1 and rank V for the
    contrast."""
    from apvast_torch.config import uses_tracking_solver
    from apvast_torch.engine.hop import half_form

    hops = HOPS if hops is None else hops
    model = _model(scene, dev, noise, overrides)
    cfg = model.config
    tracking = uses_tracking_solver(cfg)
    v = cfg.num_solutions
    resid, tail_a = [], []

    def per_hop(i, out):
        if tracking:
            resid.append(model.state.gevd_resid)
        if i >= TAIL_FROM:
            tail_a.append(out[0][:: v - 1])  # a view of ranks 1 and V

    hops_a, hops_b, hops_a_dev, hops_b_dev, states, outs, counts, ms_hop = _run_hops(
        model, label, sig, dev, hops, want_counts, card, per_hop)
    print(f"[phase 3] {label}: half_form={half_form(cfg)}, {model.rebuilds} rebuilds",
          flush=True)
    if tracking:
        r = torch.stack(resid).cpu()
        steady = (f", hops {CPU_HOPS + 1}-{hops}: min {float(r[CPU_HOPS:].min()):.4f} max "
                  f"{float(r[CPU_HOPS:].max()):.4f}" if hops > CPU_HOPS else "")
        print(f"[phase 3] {label}: {model.rebuilds} preconditioner rebuilds in {hops} hops; "
              f"gevd_resid min {float(r.min()):.4f} max {float(r.max()):.4f} "
              f"(hops 1-{hops}){steady}", flush=True)

    _compare_with_cpu(scene, label, cfg, overrides, noise, states, outs, hops_a, hops_b,
                      gate_feeds)
    contrast = _contrast(scene, tail_a)
    print(f"[phase 3] {label}: zone-A contrast over hops {TAIL_FROM + 1}-{hops}: rank 1 "
          f"{contrast[0]:.4f} dB, rank {v} {contrast[1]:.4f} dB", flush=True)
    return model, hops_a_dev, hops_b_dev, ms_hop, counts, contrast


INVERT = {"subspace_whiten": "invert", "jacobi_sweeps": 3,
          "use_pallas_subspace": True, "use_pallas_whiten": True}
DENSE = {"use_lag_statistics": False}
WEIGHTING_CONV = {"weighting_conv_taps": WEIGHTING_TAPS}
# The kernels each time-domain path launches once per hop ('invert' also
# K10a once per panel).
PRODUCTION_KERNELS = ("streaming_conv", "lag_corr", "skew_assembly", "jacobi_eigh",
                      "output_filter")
PATH_KERNELS = {
    "production": PRODUCTION_KERNELS,
    "exact": ("streaming_conv", "lag_corr", "skew_assembly", "output_filter"),
    "invert": PRODUCTION_KERNELS + ("whiten", "subspace"),
    "dense": ("streaming_conv", "statistics", "jacobi_eigh", "output_filter"),
    "weighting-conv": PRODUCTION_KERNELS + ("rowwise_conv",),
}
ROUND3_KERNELS = ("whiten", "subspace")
FD_KERNELS = ("jacobi_eigh_hermitian",)
# Kernels that no engine path calls (their phase-2 rows report 0 launches).
UNCALLED_KERNELS = ("circular_filter", "chol_tri_inverse")
# The round-3 solvers' Rayleigh-Ritz matrices are not near-diagonal (the
# CholeskyQR2 of each power step mixes the carried Ritz vectors), so K4 at
# their 2-3 sweeps leaves close eigenvectors unconverged, and a rounding-sized
# change of its input moves them (phase 2 holds K4 there against its plain
# version on the invert path's own matrices): the card and the CPU then part
# by up to 0.6 of signal scale on single hops (PERF.md, section 6). So each
# round-3 path runs as configured (launches, health, timing, contrast, and
# against the CPU the statistics and target feeds, which come before the
# solver; its loudspeaker feeds are printed) and is compared with the CPU in
# full in a second run of CPU_HOPS hops with K4 at CONVERGED_SWEEPS. The
# production, the dense and the weighting-conv path take the same
# comparison: K1 and K6 sum in another order than their plain versions, and
# at the production's 2 sweeps that rounding moved single hops' loudspeaker
# feeds by up to 0.28 of their own scale (PERF.md, section 6).
CONVERGED_SWEEPS = 8
WITNESS_HOPS = 3  # invert hops whose Rayleigh-Ritz matrices phase 2 takes
ULP_REL = 1e-7  # a relative change of about one float32 ulp
JACOBI_REMAINDER = 1.5  # K4's off-diagonal remainder against its plain version's


def _want(path, hops, **extra):
    """Launch counts of ``hops`` hops of a time-domain path."""
    from apvast_torch.ops import kernels as K

    return {name: hops if name in PATH_KERNELS[path] else 0 for name in K.WRAPPERS} | extra


def phase3(scene, dev, card, results):
    from apvast_torch import GevdSolver, production_overrides

    noise, sig = _inputs(scene)

    def configured_then_converged(label, config, want, hops=HOPS):
        """The path as configured, its statistics and target feeds held
        against the CPU, then CPU_HOPS hops of it with K4 at
        CONVERGED_SWEEPS, the loudspeaker feeds too."""
        path = drive(scene, dev, card, label, config, want, sig, noise, hops=hops,
                     gate_feeds=False)
        converged = {name: n * CPU_HOPS // hops for name, n in want.items()}
        drive(scene, dev, card, f"{label} ({CONVERGED_SWEEPS} sweeps)",
              config | {"jacobi_sweeps": CONVERGED_SWEEPS}, converged, sig, noise,
              hops=CPU_HOPS)
        return path

    prod = configured_then_converged("production", production_overrides(),
                                     _want("production", HOPS))
    exact = drive(
        scene, dev, card, "exact", production_overrides() | {"gevd_solver": GevdSolver.EIGH},
        _want("exact", HOPS), sig, noise,
    )
    dense = configured_then_converged("dense", production_overrides() | DENSE,
                                      _want("dense", HOPS))
    wconv = configured_then_converged("weighting-conv", production_overrides() | WEIGHTING_CONV,
                                      _want("weighting-conv", HOPS))
    panels = -(-scene.config.jl // 128)
    invert = configured_then_converged(
        "invert", production_overrides() | {"subspace_whiten": "invert"} | INVERT,
        _want("invert", HOPS, whiten=panels * HOPS))
    for whiten in ("solve", "newton"):
        configured_then_converged(whiten, production_overrides() | {"subspace_whiten": whiten},
                                  _want("production", CPU_HOPS), hops=CPU_HOPS)
    # Each kernel's launches on the main-path run of the path that runs it.
    launched_by = {"statistics": dense, "rowwise_conv": wconv} | {
        name: invert for name in ROUND3_KERNELS}
    for r in results:
        if r["name"] not in (*FD_KERNELS, *UNCALLED_KERNELS):
            r["launches"] = launched_by.get(r["name"], prod)[4][r["name"]]
    gates = [("production", prod, "exact", exact), ("invert", invert, "exact", exact),
             ("dense", dense, "exact", exact), ("weighting-conv", wconv, "production", prod)]
    for label, path, ref_label, ref in gates:
        for rank, p, e in zip((1, scene.config.num_eigenvectors), path[5], ref[5]):
            delta = p - e
            print(f"[phase 3] contrast gate rank {rank}: {label} {p:.4f} dB, {ref_label} "
                  f"{e:.4f} dB, delta {delta:+.4f} dB (limit {TOL_CONTRAST_DB} dB)", flush=True)
            if not abs(delta) <= TOL_CONTRAST_DB:
                raise AssertionError(f"contrast gate failed for {label} at rank {rank}: "
                                     f"{delta:+.4f} dB")
    print(f"[phase 3] steady state: production {prod[3]:.3f} ms/hop, exact {exact[3]:.3f} "
          f"ms/hop, invert {invert[3]:.3f} ms/hop, dense {dense[3]:.3f} ms/hop, weighting-conv "
          f"{wconv[3]:.3f} ms/hop card={card}", flush=True)
    return {"production": prod[:4], "invert": invert[:4], "dense": dense[:4],
            "weighting-conv": wconv[:4]}


def _fd_model(scene, device, noise, overrides):
    from apvast_torch import ApVastFD

    c = scene.config
    overrides = dict(overrides)
    rank = overrides.pop("number_of_eigenvectors", c.num_srcs)
    return ApVastFD(
        c.block_size, scene.rir_a, scene.rir_b, c.filter_length, c.modeling_delay,
        c.reference_index_a, c.reference_index_b, rank, c.mu,
        sampling_rate=c.sampling_rate, perceptual=c.perceptual, forgetting=FD_FORGETTING,
        device=device, response_noise=noise, dtype=c.dtype, **FD_SETTINGS, **overrides,
    )


def _perturbed(state, g):
    """A copy of an FD state (on the CPU) with its statistics and response
    tails changed by ULP_REL relative noise."""
    def jitter(x):
        noise = torch.randn(x.shape, generator=g, dtype=x.real.dtype)
        return x * (1 + ULP_REL * noise)

    return dataclasses.replace(state, **{
        name: jitter(getattr(state, name)) for name in ("cov", "cross", "resp", "target_resp")
    })


def _compare_fd_with_cpu(scene, label, cfg, states, outs, hops_a, hops_b, spread):
    """The first CPU_HOPS hops of an FD path on the CPU (plain versions),
    each from the card's state: per-bin statistics to TOL_STATS, target
    feeds to TOL_TARGET, loudspeaker feeds to TOL_FEEDS or, with
    ``spread``, to the Jacobi gate (see FD_TOL_FLOOR)."""
    from apvast_torch.engine import build_plan, process_hop_fd

    t2 = time.perf_counter()
    plan = build_plan(cfg, scene.rir_a, scene.rir_b, "cpu")
    g = torch.Generator().manual_seed(SEED)
    cpu_outs, own = [], []
    for i in range(CPU_HOPS):
        start = _to(states[i], "cpu")
        cpu_state, o = process_hop_fd(cfg, plan, start, hops_a[i], hops_b[i], FD_FORGETTING)
        cpu_outs.append((o.out_a, o.out_b, o.out_a_t, o.out_b_t))
        for name in ("cov", "cross"):
            _check(f"{label} hop {i + 1} statistics {name}",
                   _rel(getattr(states[i + 1], name).cpu(), getattr(cpu_state, name))[1], TOL_STATS)
        if spread:
            _, p = process_hop_fd(cfg, plan, _perturbed(start, g), hops_a[i], hops_b[i],
                                  FD_FORGETTING)
            own.append(max(_rel(p.out_a, o.out_a)[1], _rel(p.out_b, o.out_b)[1]))
    print(f"[phase 3] {label}: statistics (cov, cross) of hops 1-{CPU_HOPS} within "
          f"{TOL_STATS:.0e} of the CPU", flush=True)
    tol = TOL_FEEDS
    if spread:
        tol = min(TOL_FEEDS, max(FD_TOL_FLOOR, FD_SPREAD_FACTOR * max(own)))
        print(f"[phase 3] {label}: the CPU hop's own loudspeaker feeds under {ULP_REL:.0e} "
              f"relative changes of its state move by, per hop, "
              f"{[f'{x:.1e}' for x in own]}: feed gate {tol:.3e}", flush=True)
    for f, name in enumerate(("out_a", "out_b", "out_a_t", "out_b_t")):
        gd = torch.stack([o[f] for o in outs]).cpu()
        c = torch.stack([o[f].expand_as(gd[0]) for o in cpu_outs])
        per_hop = [f"{_rel(gd[i], c[i])[1]:.1e}" for i in range(CPU_HOPS)]
        target = name.endswith("_t")
        print(f"[phase 3] {label} {name} vs CPU, hops 1-{CPU_HOPS}: per hop {per_hop}, all "
              f"{_rel(gd, c)[1]:.3e}", flush=True)
        _check(f"{label} {name} vs CPU", _rel(gd, c)[1], TOL_TARGET if target else tol)
    print(f"[phase 3] {label}: CPU comparison took {time.perf_counter() - t2:.1f} s", flush=True)


def drive_fd(scene, dev, card, label, overrides, sig, noise, hops=None):
    """``hops`` hops of one FD configuration on the card: launch counts
    (K1 every hop, K7 every hop under fd_eigh='jacobi' with every rank),
    health, steady-state time (``_run_hops``), the first CPU_HOPS hops
    against the CPU, and zone-A contrast at rank 1 and rank V and NMSE at
    rank V over hops TAIL_FROM + 1 to ``hops``."""
    from apvast_torch.evaluation import acoustic_contrast_db, normalized_mse, predict_pressure
    from apvast_torch.ops import kernels as K

    hops = HOPS if hops is None else hops
    model = _fd_model(scene, dev, noise, overrides)
    cfg = model.config
    v = cfg.fd_num_solutions
    jacobi = cfg.fd_eigh == "jacobi" and cfg.fd_span == "all"
    want = {name: 0 for name in K.WRAPPERS} | {"streaming_conv": hops} | (
        {"jacobi_eigh_hermitian": hops} if jacobi else {})
    tail_a, tail_t = [], []

    def per_hop(i, out):
        if i >= TAIL_FROM:
            tail_a.append(out[0][[0, v - 1]])  # a copy of ranks 1 and V
            tail_t.append(out[2][0])

    hops_a, hops_b, hops_a_dev, hops_b_dev, states, outs, counts, ms_hop = _run_hops(
        model, label, sig, dev, hops, want, card, per_hop)
    _compare_fd_with_cpu(scene, label, cfg, states, outs, hops_a, hops_b, spread=jacobi)
    feeds = torch.cat(tail_a, dim=1).double()  # (2, T, srcs): ranks 1 and V
    bright = predict_pressure(feeds, scene.rir_a)
    contrast = [float(x) for x in acoustic_contrast_db(bright, predict_pressure(feeds, scene.rir_b))]
    nmse = float(normalized_mse(bright[-1], predict_pressure(torch.cat(tail_t).double(),
                                                             scene.rir_a)))
    print(f"[phase 3] {label}: V={cfg.num_eigenvectors}, zone-A contrast over hops "
          f"{TAIL_FROM + 1}-{hops}: rank 1 {contrast[0]:.4f} dB, rank V {contrast[1]:.4f} dB; "
          f"NMSE at rank V {nmse:.4f}", flush=True)
    return model, hops_a_dev, hops_b_dev, ms_hop, counts, contrast, nmse


def phase3_fd(scene, dev, card, results):
    """The frequency-domain engine's paths (see the module docstring)."""
    noise, sig = _inputs(scene)
    s = scene.config.num_srcs
    base = {"number_of_eigenvectors": s, "fd_jacobi_sweeps": FD_SWEEPS}
    jac = drive_fd(scene, dev, card, "fd-jacobi", base | {"fd_eigh": "jacobi"}, sig, noise)
    lap = drive_fd(scene, dev, card, "fd-lapack", base, sig, noise)
    full = drive_fd(scene, dev, card, "fd-full", base | {"fd_span": "full"}, sig, noise)
    coupled = drive_fd(scene, dev, card, "fd-coupled", base | {
        "fd_span": "full", "fd_bin_coupling": 7, "fd_frame_taps": 2,
        "number_of_eigenvectors": 2 * s}, sig, noise)
    for label, extra in (
        ("fd-group", {"fd_bin_coupling": 7, "fd_group_size": 4, "fd_group_rank_tol": 1e-3}),
        ("fd-cg", {"fd_coupled_iters": 4, "fd_coupled_method": "cg"}),
    ):
        drive_fd(scene, dev, card, label, base | {"fd_span": "full"} | extra, sig, noise,
                 hops=CPU_HOPS)
    for r in results:
        if r["name"] in FD_KERNELS:
            r["launches"] = jac[4][r["name"]]
    for rank, j, e in zip((1, s), jac[5], lap[5]):
        delta = j - e
        print(f"[phase 3] contrast gate rank {rank}: fd-jacobi {j:.4f} dB, fd-lapack {e:.4f} dB, "
              f"delta {delta:+.4f} dB (limit {TOL_CONTRAST_DB} dB)", flush=True)
        if not abs(delta) <= TOL_CONTRAST_DB:
            raise AssertionError(f"contrast gate failed for fd-jacobi at rank {rank}: "
                                 f"{delta:+.4f} dB")
    print(f"[phase 3] FD steady state: fd-jacobi {jac[3]:.3f}, fd-lapack {lap[3]:.3f}, "
          f"fd-full {full[3]:.3f}, fd-coupled {coupled[3]:.3f} ms/hop card={card}", flush=True)
    return {"fd-jacobi": jac[:4], "fd-full": full[:4]}


def _kernel_of(key):
    """The wrapper whose kernel a profiler key names: K7 is
    hermitian_pair_kernel<NP, WARPS> up to 64 slots, and past them, as K4,
    a form of jacobi_eigh_kernel<PER, DOUBLE, HERM>; K5 and K11 are forms of
    output_filter_kernel<OVERLAP>."""
    from apvast_torch.ops import kernels as K

    if "hermitian_pair_kernel<" in key:
        return "jacobi_eigh_hermitian"
    if "jacobi_eigh_kernel<" in key:  # its third template argument is HERM
        herm = key.split("jacobi_eigh_kernel<", 1)[1].split(",")[2].strip() == "true"
        return "jacobi_eigh_hermitian" if herm else "jacobi_eigh"
    if "output_filter_kernel<false>" in key:
        return "circular_filter"
    return next((name for name in K.WRAPPERS if f"{name}_kernel" in key), None)


def phase4(label, model, hops_a, hops_b, card, wall_ms_hop):
    """Device time by kernel and by stage over PROFILE_HOPS steady-state hops
    of one path (for the production path one rebuild period), and the
    device's idle share against the unprofiled steady-state hop time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apvast_torch.ops import kernels as K

    n = PROFILE_HOPS
    jl = model.config.jl
    rebuilds = getattr(model, "rebuilds", 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for i in range(n):
            model.process_input_buffers(hops_a[i % HOPS], hops_b[i % HOPS])
        torch.cuda.synchronize()
    rows = sorted(
        (
            (e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy_ms = max(sum(r[0] for r in rows) / n / 1e3, 1e-9)
    print(f"[phase 4] {label} path, hops {HOPS + 1}-{HOPS + n} "
          f"({getattr(model, 'rebuilds', 0) - rebuilds} preconditioner rebuilds): kernel time "
          f"{busy_ms:.3f} ms/hop ({sum(r[2] for r in rows) // n} kernels/hop); idle share "
          f"{1 - busy_ms / wall_ms_hop:.3f} of the {wall_ms_hop:.3f} ms/hop "
          f"steady state; card={card}", flush=True)
    # Device time by stage: the kernels each library op launched (the
    # (2, JL, JL) factorization, a rebuild's under the tracking solver and
    # every hop's under 'invert', apart from the small ones), and the port
    # kernels by name; "other" is the elementwise rest.
    by_shape = prof.key_averages(group_by_input_shape=True)

    def op_ms(keys, rebuild=None):
        total = 0.0
        for e in by_shape:
            if e.key not in keys:
                continue
            big = any(list(sh)[-2:] == [jl, jl] for sh in e.input_shapes if sh)
            if rebuild is None or big == rebuild:
                total += e.device_time_total
        return total / n / 1e3

    chol, tri = ("aten::linalg_cholesky_ex",), ("aten::linalg_solve_triangular",)
    stages = {
        "torch Cholesky of the (2, JL, JL) dark matrices": op_ms(chol, True),
        "triangular inverse (2, JL, JL)": op_ms(tri, True),
        "small Cholesky (RR pencil, CholeskyQR2; FD lapack path)": op_ms(chol, False),
        "small triangular solves (RR pencil; FD whitening and solves)": op_ms(tri, False),
        "eigh (torch.linalg.eigh)": op_ms(("aten::_linalg_eigh",)),
        "LU solve (torch.linalg.solve_ex)": op_ms(("aten::linalg_solve_ex",)),
        "matmuls (aten::mm, aten::bmm)": op_ms(("aten::mm", "aten::bmm")),
    }
    for name in K.WRAPPERS:
        stages[f"kernel {name}"] = sum(
            r[0] for r in rows if _kernel_of(r[1]) == name
        ) / n / 1e3
    stages["other (elementwise ops, copies, reductions)"] = busy_ms - sum(stages.values())
    for name, ms in stages.items():
        print(f"[phase 4] {label} stage {ms:8.4f} ms/hop  {ms / busy_ms:6.1%}  {name}",
              flush=True)
    for dev_us, key, count in rows[:25]:
        print(f"[phase 4] {label}   {dev_us / n / 1e3:8.4f} ms/hop  {count / n:5.1f}/hop  "
              f"{key[:90]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 4, a torch.profiler breakdown of the production, the "
                         "invert, the dense, the weighting-conv, the fd-jacobi and the "
                         "fd-full path")
    args = ap.parse_args()

    # ---- phase 0: environment ------------------------------------------
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("[phase 0] no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 1
    card = _nvidia_smi()
    print(f"[phase 0] {card}", flush=True)
    print(f"[phase 0] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[phase 0] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)

    from apvast_torch.ops.kernels import _build
    from apvast_torch.utils.scenes import scale_scene

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[phase 1] built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(per source: { {k: round(v[0], 1) for k, v in built.items()} })", flush=True)
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "Function properties for" in line:  # the kernel the next lines describe
                print(f"[phase 1] {name}: {line.split('for', 1)[1].strip()}", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"[phase 1] {name}: {line.strip()}", flush=True)

    scene = scale_scene(16)

    # ---- phase 2: kernels against their plain versions -----------------
    results = phase2(scene, dev, card)

    # ---- phase 3: the main path ----------------------------------------
    paths = phase3(scene, dev, card, results)
    paths |= phase3_fd(scene, dev, card, results)

    if args.profile:
        for label, (model, hops_a, hops_b, ms_hop) in paths.items():
            phase4(label, model, hops_a, hops_b, card, ms_hop)
    print(f"[phase 4] chip_smoke.py took {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
