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
         another order). K3 in both forms; K4 at (2, 64, 64) with 2 and 3
         sweeps on a warm-start-like (near-diagonal) input and with 8 sweeps
         on a cold random one (eigenvector columns compared up to sign: a
         converged column's sign is the rotation history's choice); K4's
         pair-block form (the wrapper's up to 64 slots) against its template
         form there and at (3, 10) and (5, 37), w and v equal bit for bit
         (max |diff| printed, required 0); and K4 at
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
         1000 rows (the JAX function pads them). The tracker's Rayleigh-Ritz
         kernel (tracked_rr, replacing no Pallas kernel) at (2, 128, 128)
         with k = 64, also at 16 and 32 zones, and at ragged widths (20, 44,
         100), also against a float64 oracle; its coordinates at (2, 128, 64)
         on K4's eigenpairs and ragged; timed beside the torch chain of the
         hop's stretch they replace (solve, K4, coordinates), graphed.
         K10b (no engine caller) at (2, 800, 800), (1, 200, 200)
         and (1, 1024, 1024) against its plain version and against a float64
         oracle, both within 1e-5 of scale (the JAX package's bound), with
         exact zeros above the diagonal; on an ill-conditioned batch (its
         whitening residual within 2x that of cholesky_ex +
         solve_triangular) and a non-PD one (non-finite output, its
         non-finite lower-triangle entries the plain version's); three
         launches with other work on the stream between them, bit for bit;
         timed beside two chains: (a) cholesky_ex + solve_triangular, (b)
         the invert path's blocked_cholesky (K10a x 7) + triangular_inverse
         (behind a longer spin, so the events see their device time). K4 and K7
         past 128 slots (the wide shared form and the global-memory form):
         warm-start-like (2, 136), (2, 200), (2, 256) real and (64, 72),
         (2, 128) complex at 8 sweeps, eigenvalues to 1e-4 of scale and the
         eigenvector residual and orthonormality within 1.5x the plain
         version's. K1 and K6, whose products run on the tensor cores in
         3xTF32, and K2, K3, K5, K9, K10a and K11, whose factorizations and
         sums take another order than their plain versions', also against a
         float64 oracle (the plain version in float64 on the card) at every
         shape above (K3 also at S = 33, J = 3 and, like its plain check, at
         J = 100 and S = 32; K5 also at (2, 37, 9); K9 also at (3, 50, 8)
         with 1 iteration, (1, 40, 16) with none and k = 112): per output,
         max|kernel - oracle| / max|oracle| within 2x the plain float32
         version's own error against it. Times by CUDA events after warm-up,
         with the 50 MB L2 flushed (a 64 MB read) before every launch and the
         card spinning while the host enqueues it (SPIN_CYCLES); the bound is the larger of bytes over
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
         Every path above runs its hop as one CUDA graph per rebuild branch,
         replayed (``engine/graph.py``), except those whose hop reads the
         device mid-hop, which run eagerly: exact, newton, fd-lapack and
         fd-group (``engine.graph.eager_reason``). Then, for the graph:
         graph    each graphed configuration (production, invert, solve,
                  dense, weighting-conv, fd-jacobi, fd-full, fd-coupled) and
                  its eager hop (``graph=False``), 8 hops each from the
                  graphed model's state: launch counts equal, statistics and
                  target feeds within 1e-5 of scale (max |diff| printed, 0
                  where bit for bit), silenced 0, the same rebuilds;
                  loudspeaker feeds within 5e-2 (the time-domain solvers in
                  a rerun with K4 at 8 sweeps, as above). Production's two
                  graphs each replayed three times from one state with other
                  work between: bit for bit. K2, K9 and K10b (cooperative
                  launches; K10b has no engine caller) captured alone at the
                  main path's shapes and replayed on fresh inputs against
                  their eager launch: bit for bit.
         serve    ``StreamHost`` on the graphed production hop: 64 hops
                  pushed in 256-sample chunks, drained hop by hop, in
                  batches of 8 (``process_hops_span``) and in batches of 8
                  as int16 PCM: every ring against ``process_input_buffers``
                  from the same state (bit for bit; PCM within half a
                  quantization step), no chunk dropped, ms per hop.
         time     host-clock steady-state ms/hop, eager against graphed in
                  turns, of production, invert, dense, weighting-conv,
                  fd-jacobi and fd-full; each graph's capture time, the
                  residual reads per hop; production's against 16.67 ms.
         eval     ``run_stream_with_metrics`` on production,
                  graphed, 64 hops: every ``hop_metrics`` field within
                  1e-4 of scale of the same metrics computed on the CPU
                  in float64 from the same feeds, every rank-1 zone-A
                  contrast of hops 7-64 positive, host-clock ms/hop of
                  hops 9-64 against ``run_stream`` (their shared loop,
                  stamped per hop, the metrics a second graph replayed
                  after the hop's; medians of four turns each, ABBA).
                  Resume: a graphed model saved after hop 32
                  (``utils/checkpoint.py``), hops 33-48 run on and again
                  in a fresh graphed model loaded from the file, feeds
                  bit for bit, on production, fd-jacobi (complex leaves)
                  and production with ``tracking_li_bf16`` (a bfloat16
                  carry). The MATLAB configuration (production values in
                  full form, MATLAB Toeplitz, normalized statistics,
                  MATLAB loading, unit-symmetric weighting norm, per-zone
                  targets; K1, K2, full-form K3, K4, K5) held against the
                  CPU as the production path is, silenced 0, its
                  contrast; ``_spectral_norm`` of its hop's (2, 800, 800)
                  matrices against the same 12 steps in float64 on the
                  CPU (1e-4) and against ``torch.linalg.matrix_norm(ord=2)``
                  in float64 (5%, the JAX package's bar on covariance
                  matrices). The bfloat16 knobs, graphed, 64 hops each
                  beside production: ``tracking_li_bf16`` silenced 0 and
                  its contrast within 0.25 dB of production's at rank 1
                  and V; ``tracking_residual_precision="default"`` (the
                  TPU's single pass, which silences hops here as in the
                  JAX engine given bfloat16 operands) its contrast
                  printed, its feeds finite, and each hop's silenced
                  count equal to the port's CPU hop's from the card's
                  state; ms/hop of the three. Offline VAST: ``vast_offline_sweep`` on
                  the north star's RIRs (J = 50, JL = 800, 1000 steps, V
                  = 50, 8 values of mu) in float64 on the card within
                  1e-6 of the CPU, timed; float32 beside it, and the BACC
                  and pressure-matching endpoints' contrast in both
                  (printed).
         multi    (``[phase 3 multi]``) also four scenes of production
                  with 'newton', whose batched hop decides each scene's
                  rebuild on the device, graphed, 16 hops of a periodic
                  input with a +40 dB onset in scene 1 at hop 12: every hop
                  bit for bit the eager batched hop from the same state,
                  each scene against its own single-scene eager hop (its
                  host decision equal, statistics and target feeds as
                  above, the feeds gated at 8 sweeps), scene 1 rebuilt alone
                  after the onset on at least one hop.
         shard    two spawned ranks in a gloo group (a file store) on the
                  one card: (a) ``scale_scene(32, num_mics=32)``, the
                  'invert' solver, JL = 1600, over a mic mesh, 8 hops each
                  against the unsharded hop from the same state
                  (``wresp_stat`` rtol 1e-4 / atol 1e-6 of its max, feeds
                  finite and rtol 1e-2 / atol 3e-2 of scale: the JAX
                  package's bars); (b) four production scenes of
                  ``scale_scene(16)`` over a scene mesh, each rank against
                  the batched hop of its own two scenes (statistics 1e-4,
                  target feeds 1e-5, loudspeaker feeds 5e-2 at 8 sweeps;
                  K1-K5 once a hop); (c) the FD engine (fd-jacobi, the FFT
                  convolution) on ``scale_scene(16, num_mics=16)`` over a
                  mic mesh, cov and cross within 1e-4 of the unsharded
                  hop's (K7 once a hop). Each rank's eager ms/hop printed.
         lag      the pair, wide and tap assemblies (full form, C0 by K2)
                  on the production path, 64 hops each through ``drive``
                  (launches, silenced 0, the CPU comparison, the contrast),
                  their statistics after the run against the skew
                  assembly's from that state (1e-4); each ``c0_method``
                  (auto = K2, conv, matmul, fft) at (4, 17, 16, 999), J =
                  50, against float64 (1e-4), timed.
         scale32  the JAX package's one-chip scaling scene (BASELINE.json
                  config 5), ``scale_scene(32)``: S = 32, M = 33, J = 50,
                  JL = 1600, V = 50, k = 64, widths not cut. Production
                  (graphed), invert (graphed) and exact (eager) for 64 hops
                  each through ``drive`` (launches, silenced 0, hops 1-2
                  against the CPU hop from the card's state: statistics and
                  target feeds to 1e-4; the feeds to 5e-2 in a rerun at 8
                  sweeps); production and invert within 0.25 dB of exact at
                  rank 1 and V (the JAX package's tracking gate); the
                  graphed production hop against the eager one over 16 hops
                  from one state, bit for bit; tools/resid_profile.py's +20
                  dB step from hop 40 (every hop's residual and the reason
                  of each rebuild printed, the stationary band printed, a
                  residual-triggered rebuild within 2 hops of the step
                  gated, the threshold the JAX package's 2.5); one stream's
                  device memory (production and invert); eager against
                  graphed ms/hop of production and invert in turns; four
                  scenes of this geometry in one graphed batched hop held
                  as ``[phase 3 multi]`` holds them, ms per batched hop and
                  memory. Phase 2 also times K1, K2, K3 (half form) and K5
                  at this scene's shapes against their plain versions
                  (1e-4).
         demo     ``examples/run_demo_torch.py`` in this process, 20 hops on
                  the card for the default (exact), ``--fast`` and ``--fd``,
                  each against its ``--cpu`` run: contrast within 0.25 dB
                  and NMSE within 5% relative per span and zone;
                  ``--fast`` launches K1, K5 and K6; wall seconds.
Phase 4  (``--profile``) device time by kernel and by stage over 32
         steady-state hops of the six timed paths and of production and
         invert at 32 speakers, eager and graphed (a graphed hop's kernels
         by name only), and the device's idle share.

The last line of output is ``{"ok": true, "device": {...}}``; any failure
exits non-zero before it.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
# K1, K6 (3xTF32), K9 and K10a against a float64 oracle: at most this times
# the plain float32 version's own error against it.
TOL_ORACLE_RATIO = 2.0
# The truncated weighting's tap count: the JAX package's production value
# (tools/device_breakdown.py, tests/test_weighting_conv.py).
WEIGHTING_TAPS = 257
# Cycles the card spins (torch.cuda._sleep) before each timed launch, ~0.1
# ms at 1980 MHz: the card stays busy while the host runs the wrapper
# (tens of microseconds of Python), so the events time the device alone.
SPIN_CYCLES = 200_000
# ~2 ms: before a timed chain of library calls (K10b's yardsticks, ~10 to
# ~60 launches), so the events time the chain's device work.
CHAIN_SPIN_CYCLES = 4_000_000


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, flush: torch.Tensor, spin: int = SPIN_CYCLES) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, L2 flushed
    before each by reading a buffer larger than it (a read leaves no dirty
    lines whose write-back would land inside the timed launch), the card
    kept busy (``spin`` cycles) while the host enqueues the launch."""
    for _ in range(3):
        fn()
    total = 0.0
    events = []
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(spin)
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


def _bound(flops, bytes_, tc_flops=None):
    """(bound ms, "operations" or "bytes", the fp32 bound ms or None): the
    larger of bytes over the memory rate and operations over the peak rate;
    with ``tc_flops`` (3xTF32: three TF32 passes of those on the tensor
    cores, the rest fp32 FMA) the fp32 bound of all ``flops`` beside it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    fp32_ms = None
    if tc_flops is not None:
        fp32_ms = max(t_ops, t_bytes)
        t_ops = (3 * tc_flops / PEAK_TF32_FLOPS + (flops - tc_flops) / PEAK_FP32_FLOPS) * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", fp32_ms


def _graphed(fn):
    """``fn`` captured in a CUDA graph (after a warm call on a side
    stream); returns its replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


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


def _jacobi_pair_against_template(cases, card):
    """K4's pair-block form (the wrapper's form up to 64 slots) against its
    template form on (label, a, sweeps): the same rotations with the same
    products, so w and v must be equal bit for bit (max |diff| printed)."""
    from apvast_torch.ops.kernels.jacobi_eigh import jacobi_eigh, jacobi_eigh_template

    for label, a, sweeps in cases:
        pair, template = jacobi_eigh(a, sweeps), jacobi_eigh_template(a, sweeps)
        torch.cuda.synchronize()
        diffs = [float((x - y).abs().max()) for x, y in zip(pair, template)]
        print(f"[phase 2] jacobi_eigh {label} {tuple(a.shape)}, {sweeps} sweeps: pair-block "
              f"form against the template form, max |diff| w {diffs[0]:.3e} v {diffs[1]:.3e} "
              f"(required 0) card={card}", flush=True)
        if not all(torch.equal(x, y) for x, y in zip(pair, template)):
            raise AssertionError(f"jacobi_eigh {label}, {sweeps} sweeps: the pair-block form "
                                 "differs from the template form")


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


def _stream_cases(cfg, plan, rnd):
    """K1, K2, K3 (half form) and K5 on inputs of ``cfg``'s shapes drawn by
    ``rnd``: per kernel its wrapper, plain version and library call on them,
    the operations (``flops``, ``tc_flops`` where tensor cores may take
    them) and bytes of its bound (each input read once, each output written
    once), the inputs (``args``) and a note of their shapes. Phase 2 (the
    north star) and the 32-speaker timing both take their cases from here."""
    from apvast_torch.ops import kernels as K

    m, s, j, v = cfg.num_mics, cfg.num_srcs, cfg.filter_length, cfg.num_solutions
    hop, block = cfg.hop, cfg.block_size
    F = torch.nn.functional
    # K1 streaming convolution: segments (2, fir_fft_size), rows M(2S+1).
    seg, kern = rnd(2, cfg.fir_fft_size) * 1e-1, plan.conv_kernels
    taps, rows = kern.shape[-1], kern.shape[1]
    hist = seg.shape[-1] - hop
    # K2 lag correlations: (4, M, S+1, N-1) with the target row, J lags.
    x2 = rnd(4, m, s + 1, cfg.statistics_buffer_length - 1) * 1e-3
    n2 = x2.shape[-1]
    k2 = n2 - j + 1
    c0_in = x2.permute(2, 0, 1, 3).reshape(s + 1, 4 * m, n2).contiguous()
    c0_w = x2[..., :k2].permute(0, 2, 1, 3).reshape(4 * (s + 1), m, k2).contiguous()
    # K3 skew assembly: lhsT (4, J*S, 2M), rhs (4, 2M, S*J), c0 (4, S, S*J).
    lhs3, rhs3, c03 = rnd(4, j * s, 2 * m), rnd(4, 2 * m, s * j), rnd(4, s, s * j)
    # K5 output filter: windowed block (2, block), V*S filter rows.
    x5 = (plan.window * rnd(2, block)).contiguous()
    f5, t5 = rnd(2, v * s, j) * 1e-2, rnd(2, v * s, block - hop) * 1e-2
    ext5 = torch.cat([x5[:, block - (j - 1):], x5], -1)[None].contiguous()
    w5 = f5.flip(-1).reshape(2 * v * s, 1, j).contiguous()
    return {
        "streaming_conv": dict(
            args=(seg, kern), shape=f"(2, {seg.shape[-1]}) x {tuple(kern.shape)}",
            kernel=lambda: K.streaming_conv(seg, kern, hop),
            plain=lambda: K.streaming_conv_plain(seg, kern, hop),
            # The one call that computes K1's function: cuBLAS on a window view.
            library=lambda: kern @ seg.unfold(-1, hop, 1)[:, hist - taps + 1: hist + 1].flip(1),
            flops=2 * 2 * rows * taps * hop, tc_flops=2 * 2 * rows * taps * hop,
            bytes=4 * (seg.numel() + kern.numel() + 2 * rows * hop)),
        "lag_corr": dict(
            args=(x2,), shape=f"{tuple(x2.shape)}, J={j}",
            kernel=lambda: K.lag_corr(x2, j), plain=lambda: K.lag_corr_plain(x2, j),
            library=lambda: F.conv1d(c0_in, c0_w, groups=4),
            flops=2 * 4 * m * (s + 1) ** 2 * j * k2,
            bytes=4 * (x2.numel() + 4 * (s + 1) ** 2 * j)),
        "skew_assembly": dict(
            args=(lhs3, rhs3, c03),
            shape=f"lhsT {tuple(lhs3.shape)}, rhs {tuple(rhs3.shape)}, c0 {tuple(c03.shape)}, "
                  "half form",
            kernel=lambda: K.lag_skew_assemble(lhs3, rhs3, c03, j, half_scaled=True),
            plain=lambda: K.lag_skew_assemble_plain(lhs3, rhs3, c03, j, half_scaled=True),
            library=None,
            flops=2 * 4 * (j * s) * (2 * m) * (s * j),
            bytes=4 * (lhs3.numel() + rhs3.numel() + c03.numel() + 4 * s * j * s * j)),
        "output_filter": dict(
            args=(x5, f5, t5), shape=f"(2, {block}) x {tuple(f5.shape)}, tail {tuple(t5.shape)}",
            kernel=lambda: K.circular_filter_overlap(x5, f5, plan.window, t5, hop),
            plain=lambda: K.circular_filter_overlap_plain(x5, f5, plan.window, t5, hop),
            library=lambda: F.conv1d(ext5, w5, groups=2),
            flops=2 * 2 * v * s * j * block,
            bytes=4 * (x5.numel() + f5.numel() + block + 2 * t5.numel() + 2 * v * s * hop)),
    }


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

    # K1, K2, K3 and K5 at the north star's shapes (shared with the
    # 32-speaker timing).
    stream = _stream_cases(cfg, plan, rnd)
    seg, kern = stream["streaming_conv"]["args"]
    taps, hist = kern.shape[-1], seg.shape[-1] - hop
    conv_w = kern.flip(-1).reshape(2 * kern.shape[1], 1, taps)
    conv_in = seg[None, :, hist - taps + 1 :].contiguous()
    (x2,) = stream["lag_corr"]["args"]
    lhs3, rhs3, c03 = stream["skew_assembly"]["args"]
    # Ragged and wide K3 shapes of their own generator (the inputs of every
    # other check are as before): reference_scene()'s J = 100 (S = 8, C =
    # 18), scale_scene(32)'s S = 32 (C = 66), and S = 33 at J = 3.
    g3 = torch.Generator().manual_seed(SEED + 3)

    def k3_inputs(s_, j_, c_):
        return tuple(torch.randn(sh, generator=g3).to(dev)
                     for sh in ((4, j_ * s_, c_), (4, c_, s_ * j_), (4, s_, s_ * j_)))

    r3_j100, r3_s32, r3_s33 = k3_inputs(8, 100, 18), k3_inputs(32, 50, 66), k3_inputs(33, 3, 4)

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
    # li is its lower triangle: the kernel reads no other (the plain version
    # multiplies all of it). Ragged: the unit tests' shapes, iterations 1
    # and 0, and the widest width the kernel takes (k = 112).
    # (The three added shapes draw from their own generator, so the inputs
    # of every other check are as before.)
    jl, k9 = cfg.jl, min(v + 14, cfg.jl)

    def k9_inputs(b, n, k, gen):
        x = torch.randn((2, b, n, n), generator=gen)
        a, d = (y @ y.transpose(1, 2) / n + torch.eye(n) for y in x)
        li = torch.tril(torch.linalg.inv(torch.linalg.cholesky(d)))
        return a.to(dev), li.to(dev).contiguous(), torch.randn((b, n, k), generator=gen).to(dev)

    a9 = spd(2, jl)
    li9 = torch.tril(torch.linalg.inv(torch.linalg.cholesky(spd(2, jl)))).contiguous()
    q9 = rnd(2, jl, k9)
    r200 = (spd(2, 200),
            torch.tril(torch.linalg.inv(torch.linalg.cholesky(spd(2, 200)))).contiguous(),
            rnd(2, 200, 24))
    g9 = torch.Generator().manual_seed(SEED + 9)
    r50, r40, r112 = (k9_inputs(3, 50, 8, g9), k9_inputs(1, 40, 16, g9),
                      k9_inputs(2, 200, 112, g9))

    # K10b: random SPD matrices of the main path's shape (2, JL, JL), which
    # pads to 896, of a padded (1, 200, 200) and of the largest padded size.
    b10, b10_200, b10_1024 = spd(2, jl), spd(1, 200), spd(1, 1024)
    eye_jl = torch.eye(jl, device=dev)

    x5, f5, t5 = stream["output_filter"]["args"]

    # The tracker's Rayleigh-Ritz kernel: the (z, 2k, 2k) raw projections
    # s^T A s and s^T B s (SPD with a 1e-6 asymmetric part, as rounding
    # leaves them) at k = 64, z = 2 (one stream), 16 and 32 (8 and 16
    # streams); ragged: padded widths and n > 2k. Its coordinates take K4's
    # eigenpairs of its own h. (Their own generator: the inputs of every
    # other check are as before.)
    grr = torch.Generator().manual_seed(SEED + 23)

    def rr_inputs(z, n):
        def raw(load):
            x = torch.randn((z, n, n), generator=grr)
            return x @ x.transpose(1, 2) / n + load * torch.eye(n) + 1e-6 * torch.randn(
                (z, n, n), generator=grr)
        return raw(0.0).to(dev), raw(0.2).to(dev)

    rr2, rr16, rr32 = rr_inputs(2, 2 * k4), rr_inputs(16, 2 * k4), rr_inputs(32, 2 * k4)
    rr_ragged = [(rr_inputs(3, 20), 8), (rr_inputs(1, 44), 22), (rr_inputs(2, 100), 30)]
    h_rr, y_rr, li_rr = K.tracked_rr(*rr2, k4)
    d_rr, v_rr = K.jacobi_eigh(h_rr, 2)

    def rr_chain(a, b):
        """The stretch of the hop the kernel and its coordinates replace:
        the torch chain, K4, the torch coordinates."""
        h, y, li = K.tracked_rr_plain(a, b, k4)
        return K.tracked_rr_coords_plain(li, y, *K.jacobi_eigh(h, 2))

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
            stream["streaming_conv"], name="streaming_conv", route="cuda",
            source="apvast_torch/csrc/streaming_conv.cu",
            replaces="apvast_tpu/ops/pallas/streaming_conv.py:53",
            context={"conv1d_ms": lambda: F.conv1d(conv_in, conv_w, groups=2)},
            oracle=[("north star", lambda a, b: K.streaming_conv(a, b, hop),
                     lambda a, b: K.streaming_conv_plain(a, b, hop), (seg, kern))],
            ragged=[
                (lambda a, b: K.streaming_conv(a, b, 50),
                 lambda a, b: K.streaming_conv_plain(a, b, 50),
                 (rnd(2, 300), rnd(2, 37, 77))),
            ],
        ),
        dict(
            stream["lag_corr"], name="lag_corr", route="cuda",
            source="apvast_torch/csrc/lag_corr.cu",
            replaces="apvast_tpu/ops/pallas/lag_corr.py:60",
            oracle=[("north star", lambda a: K.lag_corr(a, j), lambda a: K.lag_corr_plain(a, j),
                     (x2,))],
            ragged=[
                (lambda a: K.lag_corr(a, 9), lambda a: K.lag_corr_plain(a, 9),
                 (rnd(4, 3, 5, 70),)),
                (lambda a: K.lag_corr(a, 40), lambda a: K.lag_corr_plain(a, 40),
                 (rnd(4, 2, 33, 120),)),
            ],
        ),
        dict(
            # The main path's form is the half form; the full form (the
            # exact path's) is checked and timed beside it.
            stream["skew_assembly"], name="skew_assembly", route="cuda",
            source="apvast_torch/csrc/skew_assembly.cu",
            replaces="apvast_tpu/ops/pallas/skew_assembly.py:118",
            oracle=[("north star", lambda a, b, c: K.lag_skew_assemble(a, b, c, j, True),
                     lambda a, b, c: K.lag_skew_assemble_plain(a, b, c, j, True),
                     (lhs3, rhs3, c03)),
                    ("S33 J3 full form", lambda a, b, c: K.lag_skew_assemble(a, b, c, 3),
                     lambda a, b, c: K.lag_skew_assemble_plain(a, b, c, 3), r3_s33)],
            ragged=[
                (lambda a, b, c, hf=hf: K.lag_skew_assemble(a, b, c, 9, half_scaled=hf),
                 lambda a, b, c, hf=hf: K.lag_skew_assemble_plain(a, b, c, 9, half_scaled=hf),
                 (rnd(4, 9 * 5, 6), rnd(4, 6, 5 * 9), rnd(4, 5, 5 * 9)))
                for hf in (False, True)
            ] + [
                (lambda a, b, c: K.lag_skew_assemble(a, b, c, 3, half_scaled=True),
                 lambda a, b, c: K.lag_skew_assemble_plain(a, b, c, 3, half_scaled=True),
                 (rnd(2, 33 * 3, 4), rnd(2, 4, 33 * 3), rnd(2, 33, 99))),
            ] + [
                (lambda a, b, c, jj=jj: K.lag_skew_assemble(a, b, c, jj, half_scaled=True),
                 lambda a, b, c, jj=jj: K.lag_skew_assemble_plain(a, b, c, jj, half_scaled=True),
                 args)
                for jj, args in ((100, r3_j100), (50, r3_s32))
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
            oracle=[("north star", K.chol_panel, K.chol_panel_plain, (panel,))],
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
            oracle=[("north star", lambda a, b, c: K.subspace_iterate(a, b, c, 2),
                     lambda a, b, c: K.subspace_iterate_plain(a, b, c, 2), (a9, li9, q9))],
            ragged=[
                (lambda a, b, c, it=it: K.subspace_iterate(a, b, c, it),
                 lambda a, b, c, it=it: K.subspace_iterate_plain(a, b, c, it), args)
                for it, args in ((2, r200), (1, r50), (0, r40), (2, r112))
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
                dict(label="warm_3_sweeps",
                     kernel=lambda: K.jacobi_eigh(h_warm, 3),
                     plain=lambda: K.jacobi_eigh_plain(h_warm, 3)),
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
            stream["output_filter"], name="output_filter", route="cuda",
            source="apvast_torch/csrc/output_filter.cu",
            replaces="apvast_tpu/ops/pallas/output_filter.py:72",
            oracle=[("north star", lambda a, b, w, t: K.circular_filter_overlap(a, b, w, t, hop),
                     lambda a, b, w, t: K.circular_filter_overlap_plain(a, b, w, t, hop),
                     (x5, f5, plan.window, t5)),
                    ("(2, 37, 9) hop 30", lambda a, b, w, t: K.circular_filter_overlap(a, b, w, t, 30),
                     lambda a, b, w, t: K.circular_filter_overlap_plain(a, b, w, t, 30),
                     tuple(torch.randn(sh, generator=g3).to(dev)
                           for sh in ((2, 100), (2, 37, 9), (100,), (2, 37, 70))))],
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
            name="tracked_rr", route="cuda",
            source="apvast_torch/csrc/tracked_rr.cu",
            replaces="none: the torch glue of apvast_torch/ops/jdiag.py::jdiag_topk_tracked",
            kernel=lambda: K.tracked_rr(*rr2, k4),
            plain=lambda: K.tracked_rr_plain(*rr2, k4),
            library=None,
            # Context: the hop's stretch from the projections to the
            # coordinates as torch ops, replayed from a graph as the hop
            # runs it (eagerly the host's ~300 launches would be timed).
            context={"chain_graphed_ms": _graphed(lambda: rr_chain(*rr2))},
            # Per zone, FMAs: libar abar libar^T n^3 (triangles skipped), the
            # pencil's factor and inverse n^3 / 3, three wbar y 3 n^2 k, six
            # Grams (symmetric) and six row solves 6 n k^2, the Gram factors
            # k^3, h n k^2; abar, bbar read, h, y, libar written once.
            flops=2 * 2 * (4 * (2 * k4)**3 // 3 + 3 * (2 * k4)**2 * k4 + 7 * 2 * k4**3 + k4**3),
            bytes=4 * 2 * (3 * (2 * k4)**2 + 2 * k4 * k4 + k4 * k4),
            oracle=[("north star", lambda a, b: K.tracked_rr(a, b, k4),
                     lambda a, b: K.tracked_rr_plain(a, b, k4), rr2)],
            ragged=[
                (lambda a, b, k=k: K.tracked_rr(a, b, k),
                 lambda a, b, k=k: K.tracked_rr_plain(a, b, k), args)
                for args, k in rr_ragged
            ],
            extra=[
                dict(label="z16", kernel=lambda: K.tracked_rr(*rr16, k4),
                     plain=lambda: K.tracked_rr_plain(*rr16, k4)),
                dict(label="z32", kernel=lambda: K.tracked_rr(*rr32, k4),
                     plain=lambda: K.tracked_rr_plain(*rr32, k4)),
            ],
        ),
        dict(
            name="tracked_rr_coords", route="cuda",
            source="apvast_torch/csrc/tracked_rr.cu",
            replaces="none: the torch glue of apvast_torch/ops/jdiag.py::jdiag_topk_tracked",
            kernel=lambda: K.tracked_rr_coords(li_rr, y_rr, d_rr, v_rr),
            plain=lambda: K.tracked_rr_coords_plain(li_rr, y_rr, d_rr, v_rr),
            library=None,
            # Per zone n k^2 for y v and n^2 k / 2 for libar^T (y v); libar,
            # y, v read, c written once.
            flops=2 * 2 * (2 * k4 * k4 * k4 + (2 * k4)**2 * k4 // 2),
            bytes=4 * 2 * ((2 * k4)**2 + 2 * 2 * k4 * k4 + k4 * k4 + 2 * k4),
            ragged=[
                (K.tracked_rr_coords, K.tracked_rr_coords_plain,
                 (torch.tril(rnd(3, 20, 20)).contiguous(), rnd(3, 20, 7), rnd(3, 7),
                  rnd(3, 7, 7))),
            ],
        ),
        dict(
            name="circular_filter", route="cuda",
            source="apvast_torch/csrc/output_filter.cu",
            replaces="apvast_tpu/ops/pallas/output_filter.py:165",
            kernel=lambda: K.circular_filter(x5, f5),
            plain=lambda: K.circular_filter_plain(x5, f5),
            # K5's library call: the same convolution, without the overlap.
            library=stream["output_filter"]["library"],
            oracle=[("north star", K.circular_filter, K.circular_filter_plain, (x5, f5))],
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
    _jacobi_pair_against_template([
        ("north star", h_warm, 2), ("north star", h_warm, 3), ("cold", h_cold, 8),
        ("ragged", _warm(g, dev, 3, 10), 2), ("ragged", _warm(g, dev, 5, 37), 3),
    ], card)
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
            extra_ms[key] = _time_ms(fn, 50, flush, CHAIN_SPIN_CYCLES)
            print(f"[phase 2] {c['name']}: {key} (see the docstring) "
                  f"{extra_ms[key]:.5f} ms card={card}", flush=True)
        bound_ms, bound_by, fp32_ms = _bound(c["flops"], c["bytes"], c.get("tc_flops"))
        simt = ""
        if fp32_ms is not None:
            extra_ms["bound_fp32_ms"] = fp32_ms
            simt = f"bound_fp32_us={fp32_ms * 1e3:.2f} fp32_share={fp32_ms / kernel_ms:.3f} "
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


def phase2_folded(scene, dev, card, results):
    """The kernels of the scene-batched hop at the shapes it gives them
    (each kernel's leading batch axis FOLDED_N times a scene's): K1-K9,
    K10a and K7 against their plain versions (TOL_KERNEL of scale), timed
    (CUDA events, L2 flushed) beside the one-scene time of phase 2; K2's
    depth slices at both path counts. K6 and K8 at MULTI_N scenes in one
    launch against MULTI_N single-scene launches, bit for bit (each scene's
    arithmetic is a single launch's), and the one-scene launch timed again
    beside the folded one."""
    from apvast_torch.engine.plan import build_plan
    from apvast_torch.ops import kernels as K
    from apvast_torch.ops.kernels.lag_corr import depth_slices
    from apvast_torch.ops.weighting_conv import _banded_toeplitz_t, weighting_kernel

    cfg = scene.config
    n = FOLDED_N
    g = torch.Generator(device="cpu").manual_seed(SEED + 14)
    plan = build_plan(cfg, scene.rir_a, scene.rir_b, dev)
    m, s, j, hop, block = cfg.num_mics, cfg.num_srcs, cfg.filter_length, cfg.hop, cfg.block_size
    v, jl, bins = cfg.num_solutions, cfg.jl, cfg.num_bins
    n6 = cfg.statistics_buffer_length - 1
    frame = WEIGHTING_FRAME
    flush = torch.zeros(64 * 2**20 // 4, dtype=torch.float32, device=dev)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g).to(dev)

    def spd(b, size):
        x = torch.randn((b, size, size), device=dev)
        return (x @ x.transpose(1, 2) / size + torch.eye(size, device=dev)).contiguous()

    torch.manual_seed(SEED + 14)
    li9 = torch.linalg.inv(torch.linalg.cholesky(spd(2 * n, jl))).tril().contiguous()
    kern8 = weighting_kernel(0.5 + rnd(2 * n, m, bins).abs(), block, WEIGHTING_TAPS,
                             plan.idft_cos_plain)
    cases = {
        "streaming_conv": (lambda a, b: K.streaming_conv(a, b, hop),
                           lambda a, b: K.streaming_conv_plain(a, b, hop),
                           (rnd(2 * n, cfg.fir_fft_size, scale=0.1),
                            plan.conv_kernels.repeat(n, 1, 1))),
        "lag_corr": (lambda a: K.lag_corr(a, j), lambda a: K.lag_corr_plain(a, j),
                     (rnd(4 * n, m, s + 1, n6, scale=1e-3),)),
        "skew_assembly": (lambda a, b, c: K.lag_skew_assemble(a, b, c, j, True),
                          lambda a, b, c: K.lag_skew_assemble_plain(a, b, c, j, True),
                          (rnd(4 * n, j * s, 2 * m), rnd(4 * n, 2 * m, s * j),
                           rnd(4 * n, s, s * j))),
        "whiten": (K.chol_panel, K.chol_panel_plain, (spd(2 * n, 128),)),
        "subspace": (lambda a, b, c: K.subspace_iterate(a, b, c, 2),
                     lambda a, b, c: K.subspace_iterate_plain(a, b, c, 2),
                     (spd(2 * n, jl), li9, rnd(2 * n, jl, min(v + 14, jl)))),
        "jacobi_eigh": (lambda a: K.jacobi_eigh(a, 2), lambda a: K.jacobi_eigh_plain(a, 2),
                        (_warm(g, dev, 2 * n, min(v + 14, jl)),)),
        "jacobi_eigh_hermitian": (lambda a: K.jacobi_eigh_hermitian(a, FD_SWEEPS)[0],
                                  lambda a: K.jacobi_eigh_hermitian_plain(a, FD_SWEEPS)[0],
                                  (_hermitian(g, dev, 2 * bins * n, s),)),
        "output_filter": (lambda a, b, t: K.circular_filter_overlap(a, b, plan.window, t, hop),
                          lambda a, b, t: K.circular_filter_overlap_plain(a, b, plan.window, t,
                                                                          hop),
                          ((plan.window * rnd(2 * n, block)).contiguous(),
                           rnd(2 * n, v * s, j, scale=1e-2),
                           rnd(2 * n, v * s, block - hop, scale=1e-2))),
        "statistics": (lambda a, b: K.covariance(a, b, j), lambda a, b: K.covariance_plain(a, b, j),
                       (rnd(4 * n, m, s, n6, scale=1e-3), rnd(2 * n, m, n6 - j + 1, scale=1e-3))),
        "rowwise_conv": (lambda a, b: K.rowwise_circular_conv(a, b, WEIGHTING_TAPS, frame),
                         lambda a, b: K.rowwise_circular_conv_plain(a, b, WEIGHTING_TAPS, frame),
                         (rnd(4 * n, m, s, block),
                          _banded_toeplitz_t(kern8, frame, WEIGHTING_TAPS).contiguous())),
    }
    one_ms = {r["name"]: r["ms"] for r in results}
    for name, (kernel, plain, args) in cases.items():
        rel = max(e[1] for e in _errs(kernel(*args), plain(*args)))
        torch.cuda.synchronize()
        _check(f"{name} at {n} scenes' shapes", rel, TOL_KERNEL)
        ms = _time_ms(lambda: kernel(*args), 20, flush)
        note = ""
        if name == "lag_corr":
            note = (f"; depth slices {depth_slices(tuple(args[0].shape), j, dev)} at P = {4 * n}, "
                    f"{depth_slices((4, m, s + 1, n6), j, dev)} at P = 4")
        print(f"[phase 2 folded] {name} {[tuple(a.shape) for a in args]} ({n} scenes): "
              f"rel_err={rel:.3e} kernel_ms={ms:.5f}, {ms / n:.5f} a scene against "
              f"{one_ms[name]:.5f} at one scene ({ms / one_ms[name]:.2f}x for {n}x the work)"
              f"{note} card={card}", flush=True)
    # K6 and K8: MULTI_N scenes in one launch against MULTI_N single launches.
    folded = {
        "statistics": (lambda a, b: K.covariance(a, b, j), 4, 2,
                       (rnd(4 * MULTI_N, m, s, n6, scale=1e-3),
                        rnd(2 * MULTI_N, m, n6 - j + 1, scale=1e-3))),
        "rowwise_conv": (lambda a, b: K.rowwise_circular_conv(a, b, WEIGHTING_TAPS, frame), 4, 2,
                         (rnd(4 * MULTI_N, m, s, block),
                          _banded_toeplitz_t(kern8[: 2 * MULTI_N], frame,
                                             WEIGHTING_TAPS).contiguous())),
    }
    for name, (kernel, pa, pb, (a, b)) in folded.items():
        got = kernel(a, b)
        got = got if isinstance(got, tuple) else (got,)
        diff = 0.0
        for k in range(MULTI_N):
            want = kernel(a[pa * k : pa * (k + 1)], b[pb * k : pb * (k + 1)])
            want = want if isinstance(want, tuple) else (want,)
            for x, y in zip(got, want):
                rows = x.shape[0] // MULTI_N
                diff = max(diff, float((x[rows * k : rows * (k + 1)] - y).abs().max()))
        folded_ms = _time_ms(lambda: kernel(a, b), 20, flush)
        single_ms = _time_ms(lambda: kernel(a[:pa], b[:pb]), 20, flush)
        print(f"[phase 2 folded] {name}: {MULTI_N} scenes in one launch against {MULTI_N} "
              f"single-scene launches max |diff| {diff:.3e} (required 0); kernel_ms "
              f"{folded_ms:.5f} at {MULTI_N} scenes, {single_ms:.5f} at one scene (re-timed) "
              f"card={card}", flush=True)
        if diff != 0:
            raise AssertionError(f"{name}: the folded launch differs from single launches")


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
    tests/test_whiten_kernel.py holds the TPU kernel; a non-PD matrix gives
    non-finite output, in the plain version's lower-triangle entries, while
    the PD one beside it stays finite; and three launches with other work on
    the stream between them repeat bit for bit (the kernel's ready counters
    are zeroed inside each launch)."""
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
    want = K.chol_tri_inverse_plain(bad)
    torch.cuda.synchronize()
    if torch.isfinite(x[1]).all() or not torch.isfinite(x[0]).all():
        raise AssertionError("chol_tri_inverse: a non-PD matrix must give non-finite output, "
                             "a PD one finite")
    lower = torch.ones(n, n, dtype=torch.bool, device=bad.device).tril()
    if not torch.equal(torch.isfinite(x[1])[lower], torch.isfinite(want[1])[lower]):
        raise AssertionError("chol_tri_inverse: the non-PD matrix's non-finite entries differ "
                             "from the plain version's")
    print(f"[phase 2] chol_tri_inverse non-PD matrix: non-finite output in the plain version's "
          f"entries (PD matrix beside it finite) card={card}", flush=True)
    other = torch.full((2, 2048, 2048), 0.5, device=bad.device)
    runs = []
    for _ in range(3):
        runs.append(K.chol_tri_inverse(batches[0]))
        other = other @ other.transpose(1, 2) / 2048
    torch.cuda.synchronize()
    if not (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])):
        raise AssertionError("chol_tri_inverse: three launches differ")
    print(f"[phase 2] chol_tri_inverse {tuple(batches[0].shape)}: three launches, other work "
          f"between them, bit for bit card={card}", flush=True)


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
    import importlib

    from apvast_torch import production_overrides
    from apvast_torch.ops import kernels as K

    # The module (the package exports the function jdiag under its name).
    jdiag = importlib.import_module("apvast_torch.ops.jdiag")

    noise, sig = _inputs(scene)
    # Eager: the matrices are taken where the solver's Python calls K4.
    model = _model(scene, dev, noise, production_overrides() | INVERT | {"graph": False})
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
                      gate_feeds=True, cpu_hops=CPU_HOPS):
    """The first ``cpu_hops`` hops through the port on the CPU (plain versions):
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
        for i in range(cpu_hops):
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
        print(f"[phase 3] {label}: statistics of hops 1-{cpu_hops} within "
              f"{TOL_STATS:.0e} of the CPU: worst rel_err "
              f"{ {name: f'{x:.2e}' for name, x in worst.items()} }", flush=True)
    else:
        cpu = _model(scene, "cpu", noise, overrides)
        cpu_outs = [cpu.process_input_buffers(hops_a[i], hops_b[i]) for i in range(cpu_hops)]
        for name, a, b in zip(
            ("R", "r"),
            hop_statistics(cfg, states[-1].wresp_stat, states[-1].wtarget_stat),
            hop_statistics(cfg, cpu.state.wresp_stat, cpu.state.wtarget_stat),
        ):
            _compare(label, f"hop {cpu_hops} statistics {name}", a.cpu(), b, TOL_STATS)
    for f, name in enumerate(("out_a", "out_b", "out_a_t", "out_b_t")):
        g = torch.stack([o[f] for o in outs]).cpu()
        c = torch.stack([o[f].expand_as(g[0]) for o in cpu_outs])
        per_hop = [f"{_rel(g[i], c[i])[1]:.1e}" for i in range(cpu_hops)]
        target = name.endswith("_t")
        gated = target or gate_feeds
        print(f"[phase 3] {label} {name} vs CPU, hops 1-{cpu_hops}: per hop {per_hop}"
              f"{'' if gated else f', all {_rel(g, c)[1]:.1e} (not gated)'}", flush=True)
        if gated:
            _check(f"{label} {name} vs CPU", _rel(g, c)[1], TOL_TARGET if target else TOL_FEEDS)
    print(f"[phase 3] {label}: CPU comparison took {time.perf_counter() - t2:.1f} s", flush=True)


def _run_hops(model, label, sig, dev, hops, want_counts, card, per_hop, cpu_hops=CPU_HOPS):
    """``hops`` hops of ``model`` on the card from the program signals
    ``sig``: the launch counts against ``want_counts``, ``silenced == 0``,
    every output's shape (ranks, hop, srcs) and finiteness, and the host
    time of the first cpu_hops hops and of the rest (the steady state).
    ``per_hop(i, out)`` runs after each hop. Returns the CPU input hops, the
    states and outputs of the first cpu_hops hops, the counts and the
    steady-state ms/hop (None without a steady-state window)."""
    from apvast_torch.engine.graph import clone_state
    from apvast_torch.ops import kernels as K

    cfg = model.config
    hops_a = torch.as_tensor(sig[0][: hops * cfg.hop]).reshape(hops, cfg.hop)
    hops_b = torch.as_tensor(sig[1][: hops * cfg.hop]).reshape(hops, cfg.hop)
    hops_a_dev, hops_b_dev = hops_a.to(dev), hops_b.to(dev)
    torch.cuda.synchronize()

    K.reset_launch_counts()
    # A graphed model's state is its graph's static buffers: keep copies.
    states, outs = [clone_state(model.state)], []
    t_first = t0 = time.perf_counter()
    for i in range(hops):
        if i == cpu_hops:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = model.process_input_buffers(hops_a_dev[i], hops_b_dev[i])
        if i < cpu_hops:
            outs.append(out)
            states.append(clone_state(model.state))
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
    first = min(hops, cpu_hops)
    first_s = (t0 if hops > cpu_hops else t1) - t_first
    ms_hop = (t1 - t0) / (hops - cpu_hops) * 1e3 if hops > cpu_hops else None
    steady = (f"steady state {ms_hop:.3f} ms/hop over hops {cpu_hops + 1}-{hops}"
              if ms_hop is not None else "no steady-state window")
    print(f"[phase 3] {label}: S={cfg.num_srcs} JL={cfg.jl}, {hops} hops, {ranks} output ranks, "
          f"silenced=0, "
          f"first {first} hops {first_s * 1e3 / first:.3f} ms/hop, {steady} (host clock, "
          f"synchronized) card={card}", flush=True)
    return hops_a, hops_b, hops_a_dev, hops_b_dev, states, outs, counts, ms_hop


def drive(scene, dev, card, label, overrides, want_counts, sig, noise, hops=None,
          gate_feeds=True, cpu_hops=CPU_HOPS):
    """``hops`` (default HOPS) hops of one configuration on the card: launch
    counts, health, steady-state time (``_run_hops``), the first ``cpu_hops``
    hops against the CPU (the loudspeaker feeds only printed unless
    ``gate_feeds``), and the zone-A contrast of the tail feeds at rank 1 and
    rank V (None without hops past TAIL_FROM)."""
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
            resid.append(model.state.gevd_resid.clone())
        if i >= TAIL_FROM:
            tail_a.append(out[0][:: v - 1])  # a view of ranks 1 and V

    hops_a, hops_b, hops_a_dev, hops_b_dev, states, outs, counts, ms_hop = _run_hops(
        model, label, sig, dev, hops, want_counts, card, per_hop, cpu_hops)
    print(f"[phase 3] {label}: half_form={half_form(cfg)}, {model.rebuilds} rebuilds",
          flush=True)
    if tracking:
        r = torch.stack(resid).cpu()
        steady = (f", hops {cpu_hops + 1}-{hops}: min {float(r[cpu_hops:].min()):.4f} max "
                  f"{float(r[cpu_hops:].max()):.4f}" if hops > cpu_hops else "")
        print(f"[phase 3] {label}: {model.rebuilds} preconditioner rebuilds in {hops} hops; "
              f"gevd_resid min {float(r.min()):.4f} max {float(r.max()):.4f} "
              f"(hops 1-{hops}){steady}", flush=True)

    _compare_with_cpu(scene, label, cfg, overrides, noise, states, outs, hops_a, hops_b,
                      gate_feeds, cpu_hops)
    contrast = None
    if tail_a:  # hops past TAIL_FROM
        contrast = _contrast(scene, tail_a)
        print(f"[phase 3] {label}: zone-A contrast over hops {TAIL_FROM + 1}-{hops}: rank 1 "
              f"{contrast[0]:.4f} dB, rank {v} {contrast[1]:.4f} dB", flush=True)
    return model, hops_a_dev, hops_b_dev, ms_hop, counts, contrast


INVERT = {"subspace_whiten": "invert", "jacobi_sweeps": 3,
          "use_pallas_subspace": True, "use_pallas_whiten": True}
DENSE = {"use_lag_statistics": False}
WEIGHTING_CONV = {"weighting_conv_taps": WEIGHTING_TAPS}
# The kernels each time-domain path launches once per hop ('invert' also
# K10a once per panel). The tracking solver runs its Rayleigh-Ritz solve
# and coordinates around K4 (TRACKER_KERNELS); the round-3 solvers do not.
PRODUCTION_KERNELS = ("streaming_conv", "lag_corr", "skew_assembly", "jacobi_eigh",
                      "output_filter")
TRACKER_KERNELS = ("tracked_rr", "tracked_rr_coords")
PATH_KERNELS = {
    "production": PRODUCTION_KERNELS + TRACKER_KERNELS,
    "exact": ("streaming_conv", "lag_corr", "skew_assembly", "output_filter"),
    "invert": PRODUCTION_KERNELS + ("whiten", "subspace"),
    "solve": PRODUCTION_KERNELS,  # 'solve' and 'newton'
    "dense": ("streaming_conv", "statistics", "jacobi_eigh", "output_filter") + TRACKER_KERNELS,
    "weighting-conv": PRODUCTION_KERNELS + TRACKER_KERNELS + ("rowwise_conv",),
    # The kept lag assemblies: C0 by K2, laid out in torch (no K3).
    "pair": ("streaming_conv", "lag_corr", "jacobi_eigh", "output_filter") + TRACKER_KERNELS,
    "wide": ("streaming_conv", "lag_corr", "jacobi_eigh", "output_filter") + TRACKER_KERNELS,
    "tap": ("streaming_conv", "lag_corr", "jacobi_eigh", "output_filter") + TRACKER_KERNELS,
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


def configured_then_converged(scene, dev, card, sig, noise, label, config, want, hops=None,
                              cpu_hops=CPU_HOPS):
    """The path as configured (``hops``, default HOPS), its statistics and
    target feeds held against the CPU over ``cpu_hops`` hops, then
    ``cpu_hops`` hops of it with K4 at CONVERGED_SWEEPS, the loudspeaker
    feeds too. Returns ``drive``'s result for the first."""
    hops = HOPS if hops is None else hops
    path = drive(scene, dev, card, label, config, want, sig, noise, hops=hops, gate_feeds=False,
                 cpu_hops=cpu_hops)
    converged = {name: n * cpu_hops // hops for name, n in want.items()}
    drive(scene, dev, card, f"{label} ({CONVERGED_SWEEPS} sweeps)",
          config | {"jacobi_sweeps": CONVERGED_SWEEPS}, converged, sig, noise, hops=cpu_hops,
          cpu_hops=cpu_hops)
    return path


def _contrast_gates(scene, gates, tag="phase 3"):
    """Each (label, path, reference label, reference) of ``drive`` results:
    the path's zone-A contrast within TOL_CONTRAST_DB of the reference's at
    rank 1 and rank V."""
    for label, path, ref_label, ref in gates:
        for rank, p, e in zip((1, scene.config.num_eigenvectors), path[5], ref[5]):
            delta = p - e
            print(f"[{tag}] contrast gate rank {rank}: {label} {p:.4f} dB, {ref_label} "
                  f"{e:.4f} dB, delta {delta:+.4f} dB (limit {TOL_CONTRAST_DB} dB)", flush=True)
            if not abs(delta) <= TOL_CONTRAST_DB:
                raise AssertionError(f"contrast gate failed for {label} at rank {rank}: "
                                     f"{delta:+.4f} dB")


def phase3(scene, dev, card, results):
    from apvast_torch import GevdSolver, production_overrides

    noise, sig = _inputs(scene)

    held = functools.partial(configured_then_converged, scene, dev, card, sig, noise)
    prod = held("production", production_overrides(), _want("production", HOPS))
    exact = drive(
        scene, dev, card, "exact", production_overrides() | {"gevd_solver": GevdSolver.EIGH},
        _want("exact", HOPS), sig, noise,
    )
    dense = held("dense", production_overrides() | DENSE, _want("dense", HOPS))
    wconv = held("weighting-conv", production_overrides() | WEIGHTING_CONV,
                 _want("weighting-conv", HOPS))
    panels = -(-scene.config.jl // 128)
    invert = held(
        "invert", production_overrides() | {"subspace_whiten": "invert"} | INVERT,
        _want("invert", HOPS, whiten=panels * HOPS))
    for whiten in ("solve", "newton"):
        held(whiten, production_overrides() | {"subspace_whiten": whiten},
             _want("solve", CPU_HOPS), hops=CPU_HOPS)
    # Each kernel's launches on the main-path run of the path that runs it.
    launched_by = {"statistics": dense, "rowwise_conv": wconv} | {
        name: invert for name in ROUND3_KERNELS}
    for r in results:
        if r["name"] not in (*FD_KERNELS, *UNCALLED_KERNELS):
            r["launches"] = launched_by.get(r["name"], prod)[4][r["name"]]
    _contrast_gates(scene, [("production", prod, "exact", exact),
                            ("invert", invert, "exact", exact), ("dense", dense, "exact", exact),
                            ("weighting-conv", wconv, "production", prod)])
    print(f"[phase 3] steady state: production {prod[3]:.3f} ms/hop, exact {exact[3]:.3f} "
          f"ms/hop, invert {invert[3]:.3f} ms/hop, dense {dense[3]:.3f} ms/hop, weighting-conv "
          f"{wconv[3]:.3f} ms/hop card={card}", flush=True)


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

# ---- phase 3, graphed: the hop as one CUDA graph (engine/graph.py) ---------

# Overrides of the graphed configurations (FD: of ApVastFD's FD_SETTINGS),
# and which engine; the six timed and profiled paths.
GRAPHED = ("production", "invert", "solve", "dense", "weighting-conv", "fd-jacobi", "fd-full",
           "fd-coupled")
TIMED = ("production", "invert", "dense", "weighting-conv", "fd-jacobi", "fd-full")
TOL_GRAPH = 1e-5  # statistics and target feeds, graphed against eager
TIME_WARM, TIME_HOPS = 8, 32  # timing: warm-up hops, then two windows each
SERVE_HOPS, SERVE_CHUNK = 64, 256  # StreamHost: hops pushed, samples a push
REALTIME_MS = 1e3 * 800 / 48000  # one hop of the north-star scene


def _path_overrides(scene):
    from apvast_torch import production_overrides

    s = scene.config.num_srcs
    base = {"number_of_eigenvectors": s, "fd_jacobi_sweeps": FD_SWEEPS}
    prod = production_overrides()
    return {
        "production": (False, prod),
        "invert": (False, prod | {"subspace_whiten": "invert"} | INVERT),
        "solve": (False, prod | {"subspace_whiten": "solve"}),
        "dense": (False, prod | DENSE),
        "weighting-conv": (False, prod | WEIGHTING_CONV),
        "fd-jacobi": (True, base | {"fd_eigh": "jacobi"}),
        "fd-full": (True, base | {"fd_span": "full"}),
        "fd-coupled": (True, base | {"fd_span": "full", "fd_bin_coupling": 7,
                                     "fd_frame_taps": 2, "number_of_eigenvectors": 2 * s}),
    }


def _path_model(scene, dev, noise, label, graph, **extra):
    fd, overrides = _path_overrides(scene)[label]
    return (_fd_model if fd else _model)(scene, dev, noise, overrides | extra | {"graph": graph})


def _statistics(model):
    """The statistics the solver is handed, from a model's state on the card."""
    from apvast_torch import ApVastFD
    from apvast_torch.engine import hop_statistics

    if isinstance(model, ApVastFD):
        return model.state.cov, model.state.cross
    return hop_statistics(model.config, model.state.wresp_stat, model.state.wtarget_stat)


def _graph_against_eager(scene, dev, card, label, noise, x, hops=CPU_HOPS, **extra):
    """``hops`` hops of a graphed and an eager model, each hop from the
    graphed model's state: launch counts equal, statistics and target feeds
    within TOL_GRAPH of scale, loudspeaker feeds printed, silenced == 0, the
    same rebuilds. Returns the worst (rel_err, max |diff|) of each."""
    from apvast_torch.engine.graph import clone_state
    from apvast_torch.ops import kernels as K

    graphed = _path_model(scene, dev, noise, label, None, **extra)
    eager = _path_model(scene, dev, noise, label, False, **extra)
    if extra:
        label = f"{label} ({extra['jacobi_sweeps']} sweeps)"
    if not graphed.graphed or eager.graphed:
        raise AssertionError(f"{label}: graphed={graphed.graphed}, eager={eager.graphed}")
    worst = {"statistics": (0.0, 0.0), "target feeds": (0.0, 0.0),
             "loudspeaker feeds": (0.0, 0.0)}

    def note(key, a, b):
        diff, rel = _rel(a, b)
        worst[key] = (max(worst[key][0], rel), max(worst[key][1], diff))

    for i in range(hops):
        eager.state = clone_state(graphed.state)
        K.reset_launch_counts()
        got = graphed.process_input_buffers(x[0, i], x[1, i])
        counts = K.launch_counts()
        K.reset_launch_counts()
        want = eager.process_input_buffers(x[0, i], x[1, i])
        if counts != K.launch_counts():
            raise AssertionError(f"{label} hop {i + 1}: graphed launches {counts}, eager "
                                 f"{K.launch_counts()}")
        for a, b in zip(_statistics(graphed), _statistics(eager)):
            note("statistics", a, b)
        for f in range(4):
            if want[f] is not None:
                note("target feeds" if f >= 2 else "loudspeaker feeds", got[f], want[f])
    silenced = (int(graphed.silenced.item()), int(eager.silenced.item()))
    print(f"[phase 3 graph] {label} ({scene.name}): {hops} hops from one state, graphed against "
          "eager: "
          + ", ".join(f"{k} rel_err {r:.3e} max|diff| {d:.3e}" for k, (r, d) in worst.items())
          + f"; launches equal; rebuilds {graphed.rebuilds} / {eager.rebuilds}; silenced "
          f"{silenced}; capture s {_capture_s(graphed)} card={card}", flush=True)
    for key in ("statistics", "target feeds"):
        _check(f"{label} graphed {key}", worst[key][0], TOL_GRAPH)
    if silenced != (0, 0) or graphed.rebuilds != eager.rebuilds:
        raise AssertionError(f"{label}: silenced {silenced}, rebuilds {graphed.rebuilds} / "
                             f"{eager.rebuilds}")
    return worst


def _capture_s(model):
    """Seconds of each branch's capture of ``model``'s graph (the hop
    meter's set-up spans)."""
    from apvast_torch.observability import meter

    owner = id(model.graph)
    return {name.split(".", 1)[1]: round(seconds, 3) for name, seconds, who in meter().setup
            if who == owner and name.startswith("capture.")}


def _replays_bit_for_bit(scene, dev, card, noise, x):
    """The production graph's two branches, each replayed three times from
    one saved state with other work on the stream between the replays."""
    from apvast_torch.engine.graph import clone_state

    model = _path_model(scene, dev, noise, "production", None)
    for i in range(TAIL_FROM + 1):  # past the warmup
        model.process_input_buffers(x[0, i], x[1, i])
    saved = clone_state(model.state)
    for rebuilt in (False, True):
        runs = []
        for _ in range(3):
            model.state = saved
            y = torch.randn(2048, 2048, device=dev)
            (y @ y).sum()
            model.graph.stage(x[0, TAIL_FROM + 1], x[1, TAIL_FROM + 1])
            out = model.graph.replay(rebuilt)
            runs.append([t.clone() for t in (out.out_a, out.out_b, out.out_a_t, out.out_b_t)]
                        + [t.clone() for t in vars(model.state).values()
                           if isinstance(t, torch.Tensor)])
        diff = max(float((a - b).abs().max()) for run in runs[1:] for a, b in zip(run, runs[0]))
        print(f"[phase 3 graph] production {'rebuild' if rebuilt else 'no-rebuild'} graph, three "
              f"replays from one state, other work between them: outputs and state max |diff| "
              f"{diff:.3e} (required 0) card={card}", flush=True)
        if diff != 0:
            raise AssertionError("graph replays differ")


def _cooperative_alone(dev, card):
    """K2, K9 and K10b (cooperative launches) captured alone at the main
    path's shapes, replayed on fresh inputs against the eager launch: bit
    for bit (K10b has no engine caller, so this is its only capture)."""
    from apvast_torch.ops import kernels as K

    def spd(g, b, n):
        x = torch.randn(b, n, n, generator=g).to(dev)
        return (x @ x.transpose(1, 2) / n + torch.eye(n, device=dev)).contiguous()

    def args(name, seed):
        g = torch.Generator().manual_seed(seed)
        if name == "lag_corr":
            return (torch.randn(4, 17, 17, 999, generator=g).to(dev), 50)
        if name == "subspace":
            li = torch.linalg.inv(torch.linalg.cholesky(spd(g, 2, 800))).contiguous()
            return (spd(g, 2, 800), li, torch.randn(2, 800, 64, generator=g).to(dev), 2)
        return (spd(g, 2, 800),)

    for name in ("lag_corr", "subspace", "chol_tri_inverse"):
        fn = K.WRAPPERS[name]
        static = args(name, 1)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*static)
        out = out if isinstance(out, tuple) else (out,)
        diff = 0.0
        for seed in (2, 3):
            fresh = args(name, seed)
            for a, b in zip(static, fresh):
                if isinstance(a, torch.Tensor):
                    a.copy_(b)
            graph.replay()
            want = fn(*fresh)
            want = want if isinstance(want, tuple) else (want,)
            diff = max(diff, max(float((a - b).abs().max()) for a, b in zip(out, want)))
        print(f"[phase 3 graph] {name} captured alone, two replays on fresh inputs against the "
              f"eager launch: max |diff| {diff:.3e} (required 0) card={card}", flush=True)
        if diff != 0:
            raise AssertionError(f"{name}: a replay differs from the eager launch")


def phase3_graph(scene, dev, card):
    """Every graphed configuration against its eager hop, hop by hop from
    one state (the solvers with K4 also at CONVERGED_SWEEPS, where the
    loudspeaker feeds are gated at TOL_FEEDS; the FD paths' feeds gated at
    TOL_FEEDS as configured), replays bit for bit, and K2, K9 and K10b
    captured alone."""
    noise, sig = _inputs(scene)
    x = torch.as_tensor(sig).to(dev).reshape(2, HOPS, -1)
    for label in GRAPHED:
        fd = _path_overrides(scene)[label][0]
        feeds = _graph_against_eager(scene, dev, card, label, noise, x)["loudspeaker feeds"][0]
        if not fd:
            feeds = _graph_against_eager(scene, dev, card, label, noise, x,
                                         jacobi_sweeps=CONVERGED_SWEEPS)["loudspeaker feeds"][0]
            print(f"[phase 3 graph] {label} at {CONVERGED_SWEEPS} sweeps: loudspeaker feeds "
                  f"rel_err {feeds:.3e} (limit {TOL_FEEDS})", flush=True)
        _check(f"{label} graphed loudspeaker feeds", feeds, TOL_FEEDS)
    _replays_bit_for_bit(scene, dev, card, noise, x)
    _cooperative_alone(dev, card)


def phase3_serve(scene, dev, card):
    """StreamHost on the graphed production hop: SERVE_HOPS hops pushed in
    SERVE_CHUNK-sample chunks, drained hop by hop (batch_hops 1), in
    batches of 8, and in batches of 8 as int16 PCM; every ring against the
    feeds of process_input_buffers from the same state (bit for bit, PCM
    within half a quantization step), no chunk dropped, ms per hop of each
    drain."""
    from apvast_torch import StreamHost
    from apvast_torch.observability import meter

    noise, sig = _inputs(scene)
    cfg = scene.config
    hop, s, n = cfg.hop, cfg.num_srcs, SERVE_HOPS
    ref = _path_model(scene, dev, noise, "production", None)
    x = torch.as_tensor(sig).to(dev).reshape(2, HOPS, -1)
    want = [ref.process_input_buffers(x[0, i], x[1, i])[:2] for i in range(n)]
    want = np.stack([torch.cat([w[z][-1] for w in want]).cpu().numpy().T for z in (0, 1)])
    peak = float(np.abs(want).max())
    for batch, pcm in ((1, False), (8, False), (8, True)):
        model = _path_model(scene, dev, noise, "production", None)
        reads0 = meter().resid_reads
        host = StreamHost(model, span_index=-1, backlog_hops=n, batch_hops=batch, pcm_feeds=pcm)
        for start in range(0, n * hop, SERVE_CHUNK):
            chunk = slice(start, start + SERVE_CHUNK)
            host.push_input(sig[0, chunk], sig[1, chunk])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = host.process_pending()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        got = np.stack([[host.pull_output(z, k, n * hop) for k in range(s)] for z in ("a", "b")])
        diff = float(np.abs(got - want).max())
        # Half a quantization step, and the float32 rounding of the scale
        # and of the dequantization.
        bar = peak * (0.5 / 32766 + 4 * np.finfo(np.float32).eps) if pcm else 0.0
        print(f"[phase 3 serve] StreamHost batch_hops={batch} pcm_feeds={pcm}: {done} hops in "
              f"{SERVE_CHUNK}-sample chunks, {ms:.3f} ms/hop (host clock, drain of the whole "
              f"backlog), dropped_input_chunks={host.dropped_input_chunks}, rings against "
              f"process_input_buffers max |diff| {diff:.3e} (limit {bar:.3e}); residual reads "
              f"{meter().resid_reads - reads0} in {n} hops card={card}", flush=True)
        if done != n or host.dropped_input_chunks or got.shape != want.shape or diff > bar:
            raise AssertionError(f"StreamHost batch_hops={batch} pcm={pcm}: {done} hops, "
                                 f"{host.dropped_input_chunks} drops, max |diff| {diff:.3e}")


def _eager_graphed_ms(scene, dev, card, noise, x, label, tag="phase 3 time"):
    """Host-clock steady-state ms/hop of one path, eager against graphed,
    both from one state and input, in turns (eager, graphed, graphed, eager
    over two TIME_HOPS windows after TIME_WARM hops); the graph's capture
    time and residual reads per hop printed. Returns (eager model, graphed
    model, inputs, eager ms, graphed ms)."""
    models = [_path_model(scene, dev, noise, label, graph) for graph in (False, None)]
    for m in models:
        for i in range(TIME_WARM):
            m.process_input_buffers(x[0, i], x[1, i])

    def timed(m, start):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(start, start + TIME_HOPS):
            m.process_input_buffers(x[0, i % HOPS], x[1, i % HOPS])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TIME_HOPS * 1e3

    from apvast_torch.observability import meter

    reads0 = meter().resid_reads
    w1, w2 = TIME_WARM, TIME_WARM + TIME_HOPS
    e1, g1, g2, e2 = (timed(models[0], w1), timed(models[1], w1), timed(models[1], w2),
                      timed(models[0], w2))
    eager, graphed = (e1 + e2) / 2, (g1 + g2) / 2
    reads = (meter().resid_reads - reads0) / (2 * TIME_HOPS)
    print(f"[{tag}] {label}: steady state eager {eager:.3f} ms/hop ({e1:.3f}, "
          f"{e2:.3f}), graphed {graphed:.3f} ms/hop ({g1:.3f}, {g2:.3f}), "
          f"{eager / graphed:.2f}x; "
          f"capture s {_capture_s(models[1])}; residual reads {reads:.3f} a hop; rebuilds "
          f"{models[0].rebuilds} / {models[1].rebuilds} (host clock, synchronized) "
          f"card={card}", flush=True)
    return (*models, x, eager, graphed)


def phase3_time(scene, dev, card):
    """Host-clock steady-state ms/hop of each TIMED path, eager against
    graphed, both from one state and input, in turns (eager, graphed,
    graphed, eager over two TIME_HOPS windows after TIME_WARM hops); the
    capture time of each graph and the residual reads per hop. Returns
    label -> (eager model, graphed model, inputs, eager ms, graphed ms)."""
    noise, sig = _inputs(scene)
    x = torch.as_tensor(sig).to(dev).reshape(2, HOPS, -1)
    out = {}
    for label in TIMED:
        out[label] = _eager_graphed_ms(scene, dev, card, noise, x, label)
    print(f"[phase 3 time] production graphed {out['production'][4]:.3f} ms/hop against the "
          f"{REALTIME_MS:.2f} ms real-time limit of one stream (a measurement, not a gate) "
          f"card={card}", flush=True)
    return out


# ---- phase 3, multi-stream: N scenes in one batched hop (parallel/mesh.py) --

# The held configurations (MULTI_N scenes, graphed, each scene against its own
# single-scene hop), the folded kernel shapes of phase 2, and the timed scene
# counts (production at every count, the other paths at 1 and 8).
MULTI_HELD = ("production", "invert", "dense", "weighting-conv", "fd-jacobi")
MULTI_N = 4
FOLDED_N = 8
MULTI_TIMED = {"production": (1, 2, 4, 8, 16), "invert": (1, 8), "dense": (1, 8),
               "fd-jacobi": (1, 8)}
MULTI_PROFILE_N = 8
WEIGHTING_FRAME = 160  # the truncated weighting's frame B at block 1600
TOL_MULTI_TARGET = 1e-5  # target feeds: the same arithmetic scene by scene
FD_PATH_KERNELS = ("streaming_conv", "jacobi_eigh_hermitian")


def _scene_pairs(scene, n):
    """The RIR pairs of ``n`` scenes, as tools/multi_stream.py builds them:
    scene 0 the north-star scene, scene i > 0 1e-3 * correlated_rirs with
    seeds 100 + i (zone A) and 200 + i (zone B), the same configuration."""
    from apvast_torch.utils.rir import correlated_rirs

    c = scene.config
    return [(scene.rir_a, scene.rir_b)] + [
        tuple(1e-3 * correlated_rirs(c.rir_length, c.num_srcs, c.num_mics, seed=base + i)
              for base in (100, 200))
        for i in range(1, n)
    ]


class _MultiFD:
    """The scene-batched FD hop, graphed (``engine/graph.py``,
    ``batched=True``): the JAX package serves several FD scenes through
    ``parallel.mesh.sharded_multi_scene_fd_hop`` only, with no model class."""

    def __init__(self, cfg, pairs, dev, forgetting):
        from apvast_torch.engine import build_plan, init_fd_state
        from apvast_torch.engine.graph import GraphedHop
        from apvast_torch.parallel.mesh import stack_plans, stack_states

        self.config, self.rebuilds, self.graphed = cfg, 0, True
        plans = [build_plan(cfg, a, b, dev) for a, b in pairs]
        states = [init_fd_state(cfg, dev, generator=torch.Generator().manual_seed(i))
                  for i in range(len(pairs))]
        self.graph = GraphedHop(cfg, stack_plans(plans), stack_states(states), forgetting,
                                batched=True)
        self.plan, self.forgetting = self.graph.plan, forgetting
        self.silenced = torch.zeros(len(pairs), dtype=torch.int32, device=dev)

    @property
    def state(self):
        return self.graph.state

    def process_input_buffers(self, hops_a, hops_b):
        self.graph.stage(hops_a, hops_b)
        out = self.graph.replay(False)
        self.silenced = self.silenced + out.silenced
        return out


def _multi_model(scene, dev, label, pairs, **extra):
    """The scenes of ``pairs`` under one path (``_path_overrides``) in one
    batched hop, graphed: ``MultiSceneApVast`` for the time domain,
    :class:`_MultiFD` for the FD engine; its configuration is the
    single-scene model's."""
    from apvast_torch import MultiSceneApVast

    fd = _path_overrides(scene)[label][0]
    single = _path_model(scene, dev, None, label, False, **extra)
    if fd:
        return _MultiFD(single.config, pairs, dev, single.forgetting)
    model = MultiSceneApVast(single.config, pairs, device=dev)
    if not model.graphed:
        raise AssertionError(f"{label}: the batched hop is not graphed ({model.eager_reason})")
    return model


def _multi_inputs(cfg, dev, hops, n):
    """(2, hops, n, hop) seeded program signals on the card."""
    rng = np.random.default_rng(SEED + n)
    return torch.as_tensor(rng.standard_normal((2, hops, n, cfg.hop)).astype(np.float32)).to(dev)


def _multi_want(scene, label):
    """Launch counts of one hop of a path, whatever the scene count."""
    from apvast_torch.ops import kernels as K

    if _path_overrides(scene)[label][0]:
        return {name: int(name in FD_PATH_KERNELS) for name in K.WRAPPERS}
    panels = -(-scene.config.jl // 128)
    return _want(label, 1, **({"whiten": panels} if label == "invert" else {}))


def _multi_statistics(model, state):
    """The statistics of every scene of a batched state, as the batched hop
    computes them (the statistics kernels at their folded shapes), (N, ...)
    each; the FD engine's (cov, cross)."""
    from apvast_torch.engine import hop_statistics

    if isinstance(model, _MultiFD):
        return state.cov, state.cross
    return torch.func.vmap(lambda w, t: hop_statistics(model.config, w, t))(
        state.wresp_stat, state.wtarget_stat)


def _single_statistics(model, state):
    from apvast_torch.engine import hop_statistics

    if isinstance(model, _MultiFD):
        return state.cov, state.cross
    return hop_statistics(model.config, state.wresp_stat, state.wtarget_stat)


def _multi_held(scene, dev, card, pairs, label, **extra):
    """MULTI_N scenes of one path, graphed, CPU_HOPS hops: before each hop
    every scene's state is taken from the batched state, and after it each
    scene's outputs and statistics are held against that scene's own
    single-scene hop (eager, its kernels at one scene's shapes) from that
    state, under the batched hop's rebuild decision: statistics within
    TOL_STATS of scale (K2's depth slices follow the path count, so its
    sums take another order), target feeds within TOL_MULTI_TARGET of the
    scene's CPU_HOPS hops' scale (FD: cuBLAS picks its matmul-DFT kernels
    by the row count), the loudspeaker feeds printed and returned. Also: launch counts of the
    batched hop equal to each single hop's and to the path's (each kernel
    once, K10a once a panel), the rebuild decision that of any scene's own
    predicate (one stale scene rebuilds all), silenced 0."""
    from apvast_torch.config import uses_tracking_solver
    from apvast_torch.engine import process_hop, process_hop_fd
    from apvast_torch.engine.graph import clone_state
    from apvast_torch.engine.hop import rebuild_predicate
    from apvast_torch.ops import kernels as K
    from apvast_torch.parallel.mesh import scene_of

    model = _multi_model(scene, dev, label, pairs[:MULTI_N], **extra)
    cfg, fd = model.config, isinstance(model, _MultiFD)
    tracking = not fd and uses_tracking_solver(cfg)
    if extra:
        label = f"{label} ({extra['jacobi_sweeps']} sweeps)"
    x = _multi_inputs(cfg, dev, CPU_HOPS, MULTI_N)
    want_counts = _multi_want(scene, label.split()[0])
    worst = {"statistics": 0.0}
    feeds = {name: ([], []) for name in ("out_a_t", "out_b_t", "out_a", "out_b")}
    rebuilds = []
    for i in range(CPU_HOPS):
        before = clone_state(model.state)
        own = [tracking and rebuild_predicate(cfg, before.gevd_hop,
                                              lambda k=k: float(before.gevd_resid[k]))
               for k in range(MULTI_N)]
        K.reset_launch_counts()
        out = model.process_input_buffers(x[0, i], x[1, i])
        counts = K.launch_counts()
        if counts != want_counts:
            raise AssertionError(f"multi {label} hop {i + 1}: launches {counts}, want "
                                 f"{want_counts}")
        if tracking and out.rebuilt != any(own):
            raise AssertionError(f"multi {label} hop {i + 1}: rebuilt {out.rebuilt}, the "
                                 f"scenes' own decisions {own}")
        rebuilds.append(bool(out.rebuilt))
        stats = _multi_statistics(model, model.state)
        for k in range(MULTI_N):
            plan_k, state_k = scene_of(model.plan, k), clone_state(scene_of(before, k))
            K.reset_launch_counts()
            if fd:
                new_k, out_k = process_hop_fd(cfg, plan_k, state_k, x[0, i, k], x[1, i, k],
                                              forgetting=model.forgetting)
            else:
                new_k, out_k = process_hop(cfg, plan_k, state_k, x[0, i, k], x[1, i, k],
                                           rebuild_override=out.rebuilt)
            if K.launch_counts() != counts:
                raise AssertionError(f"multi {label} hop {i + 1} scene {k}: single-scene "
                                     f"launches {K.launch_counts()}, batched {counts}")
            for a, b in zip(stats, _single_statistics(model, new_k)):
                worst["statistics"] = max(worst["statistics"], _rel(a[k], b)[1])
            for name, (got, want) in feeds.items():
                got.append(getattr(out, name)[k].clone())
                want.append(getattr(out_k, name))
    # Feeds against the scale of each scene's CPU_HOPS hops (a cold hop's
    # own emission can be all but zero).
    for key, names in (("target feeds", ("out_a_t", "out_b_t")),
                       ("loudspeaker feeds", ("out_a", "out_b"))):
        worst[key] = max(_rel(torch.stack(feeds[name][0][k::MULTI_N]),
                              torch.stack(feeds[name][1][k::MULTI_N]))[1]
                         for name in names for k in range(MULTI_N))
    silenced = model.silenced.tolist()
    print(f"[phase 3 multi] {label} ({scene.name}): {MULTI_N} scenes graphed, {CPU_HOPS} hops, "
          f"each scene against its own single-scene hop from the same state: "
          + ", ".join(f"{k} rel_err {v:.3e}" for k, v in worst.items())
          + f"; launches a hop {({k: v for k, v in want_counts.items() if v})} (batched = single);"
          f" rebuilds {rebuilds}; silenced {silenced}; capture s {_capture_s(model)} card={card}",
          flush=True)
    _check(f"multi {label} statistics", worst["statistics"], TOL_STATS)
    _check(f"multi {label} target feeds", worst["target feeds"], TOL_MULTI_TARGET)
    if any(silenced):
        raise AssertionError(f"multi {label}: silenced {silenced}")
    return worst["loudspeaker feeds"]


def _multi_time(scene, dev, card, pairs, label, n):
    """Host-clock ms per batched hop of the first ``n`` scenes of ``pairs``,
    graphed, over two TIME_HOPS windows after TIME_WARM hops. Returns
    (model, inputs, ms)."""
    model = _multi_model(scene, dev, label, pairs[:n])
    x = _multi_inputs(model.config, dev, HOPS, n)
    for i in range(TIME_WARM):
        model.process_input_buffers(x[0, i], x[1, i])
    windows = []
    for start in (TIME_WARM, TIME_WARM + TIME_HOPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(start, start + TIME_HOPS):
            model.process_input_buffers(x[0, i % HOPS], x[1, i % HOPS])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / TIME_HOPS * 1e3)
    ms = sum(windows) / 2
    print(f"[phase 3 multi] {label} N={n}: {ms:.3f} ms per batched hop ({windows[0]:.3f}, "
          f"{windows[1]:.3f}), {ms / n:.3f} ms per stream, {n * REALTIME_MS / ms:.2f} streams "
          f"per card (N x {REALTIME_MS:.2f} / ms per batched hop); rebuilds {model.rebuilds}; "
          f"capture s {_capture_s(model)} (host clock, synchronized) card={card}", flush=True)
    return model, x, ms


def phase3_multi(scene, dev, card):
    """Multi-stream serving (see the module docstring): the held
    comparisons of MULTI_HELD at MULTI_N scenes, then the timed scene
    counts. Returns the profiled model, its inputs and its ms per hop."""
    pairs = _scene_pairs(scene, max(MULTI_N, *(max(n) for n in MULTI_TIMED.values())))
    for label in MULTI_HELD:
        feeds = _multi_held(scene, dev, card, pairs, label)
        if label != "fd-jacobi":
            print(f"[phase 3 multi] {label}: loudspeaker feeds rel_err {feeds:.3e} at "
                  f"{_path_model(scene, dev, None, label, False).config.jacobi_sweeps} sweeps "
                  "(printed; gated at 8 sweeps)", flush=True)
            feeds = _multi_held(scene, dev, card, pairs, label, jacobi_sweeps=CONVERGED_SWEEPS)
        _check(f"multi {label} loudspeaker feeds", feeds, TOL_FEEDS)
    feeds = _multi_newton(scene, dev, card, pairs)
    print(f"[phase 3 multi] newton: loudspeaker feeds rel_err {feeds:.3e} at 2 sweeps (printed; "
          "gated at 8 sweeps)", flush=True)
    _check("multi newton loudspeaker feeds",
           _multi_newton(scene, dev, card, pairs, sweeps=CONVERGED_SWEEPS), TOL_FEEDS)
    profiled = None
    for label, counts in MULTI_TIMED.items():
        per_n = {}
        for n in counts:
            model, x, ms = _multi_time(scene, dev, card, pairs, label, n)
            per_n[n] = ms
            if label == "production" and n == MULTI_PROFILE_N:
                profiled = (model, x, ms)
            del model
        print(f"[phase 3 multi] {label}: ms per stream "
              + ", ".join(f"N={n} {ms / n:.3f}" for n, ms in per_n.items())
              + "; streams per card "
              + ", ".join(f"N={n} {n * REALTIME_MS / ms:.2f}" for n, ms in per_n.items())
              + f" card={card}", flush=True)
    return profiled


# ---- phase 3, 'newton' batched: a select a scene (ops/jdiag.py) ------------

NEWTON_HOPS = 16
NEWTON_ONSET = 11  # scene 1's input steps up 40 dB at this hop (0-based)


def _newton_inputs(cfg, dev, n):
    """(2, NEWTON_HOPS, n, hop) on the card: one seeded hop of noise a scene
    repeated (a periodic input, so that once the buffers are full each
    scene's dark matrices stop changing and 'newton' refreshes its carried
    inverse instead of rebuilding it), scene 1 40 dB down before
    NEWTON_ONSET (an onset)."""
    base = np.random.default_rng(SEED + 7).standard_normal((2, 1, n, cfg.hop)).astype(np.float32)
    x = np.repeat(base, NEWTON_HOPS, axis=1)
    x[:, :NEWTON_ONSET, 1] *= 0.01
    return torch.as_tensor(x).to(dev)


def _multi_newton(scene, dev, card, pairs, sweeps=None):
    """MULTI_N scenes of production with 'newton' in one batched hop, which
    decides each scene's rebuild on the device (a select of both branches),
    graphed, NEWTON_HOPS hops: every hop against the eager batched hop from
    the same state (bit for bit: the condition for capturing it), and each
    scene against its own single-scene eager hop, which decides on the host:
    the same decision, statistics within TOL_STATS, target feeds within
    TOL_MULTI_TARGET, launch counts equal; the onset rebuilds scene 1 alone
    on at least one hop. Returns the loudspeaker feeds' worst error."""
    from apvast_torch import MultiSceneApVast, production_overrides
    from apvast_torch.engine import process_hop
    from apvast_torch.engine.graph import clone_state
    from apvast_torch.ops import kernels as K
    from apvast_torch.parallel.mesh import scene_of
    from apvast_torch.utils.scenes import scale_scene

    extra = {} if sweeps is None else {"jacobi_sweeps": sweeps}
    cfg = scale_scene(16, **(production_overrides() | {"subspace_whiten": "newton"} | extra)).config
    label = "newton" if sweeps is None else f"newton ({sweeps} sweeps)"
    model = MultiSceneApVast(cfg, pairs[:MULTI_N], device=dev)
    eager = MultiSceneApVast(cfg, pairs[:MULTI_N], device=dev, graph=False)
    if not model.graphed:
        raise AssertionError(f"{label}: the batched hop is not graphed ({model.eager_reason})")
    x = _newton_inputs(cfg, dev, MULTI_N)
    worst = {"graph against eager": 0.0, "statistics": 0.0}
    feeds = {name: ([], []) for name in ("out_a_t", "out_b_t", "out_a", "out_b")}
    decisions = []
    for i in range(NEWTON_HOPS):
        before = clone_state(model.state)
        eager.state = clone_state(before)
        K.reset_launch_counts()
        out = model.process_input_buffers(x[0, i], x[1, i])
        counts = K.launch_counts()
        ref = eager.process_input_buffers(x[0, i], x[1, i])
        for name in ("out_a", "out_b", "out_a_t", "out_b_t", "rebuilt", "silenced"):
            diff = (getattr(out, name).double() - getattr(ref, name).double()).abs().max()
            worst["graph against eager"] = max(worst["graph against eager"], float(diff))
        for f in dataclasses.fields(before):
            if isinstance(getattr(before, f.name), torch.Tensor):
                diff = (getattr(model.state, f.name).double()
                        - getattr(eager.state, f.name).double()).abs().max()
                worst["graph against eager"] = max(worst["graph against eager"], float(diff))
        decisions.append(out.rebuilt.tolist())
        stats = _multi_statistics(model, model.state)
        for k in range(MULTI_N):
            K.reset_launch_counts()
            new_k, out_k = process_hop(cfg, scene_of(model.plan, k), clone_state(scene_of(before, k)),
                                       x[0, i, k], x[1, i, k])
            if K.launch_counts() != counts:
                raise AssertionError(f"multi {label} hop {i + 1} scene {k}: single-scene "
                                     f"launches {K.launch_counts()}, batched {counts}")
            if out_k.rebuilt != decisions[-1][k]:
                raise AssertionError(f"multi {label} hop {i + 1} scene {k}: batched decision "
                                     f"{decisions[-1][k]}, its own hop's {out_k.rebuilt}")
            for a, b in zip(stats, _single_statistics(model, new_k)):
                worst["statistics"] = max(worst["statistics"], _rel(a[k], b)[1])
            for name, (got, want) in feeds.items():
                got.append(getattr(out, name)[k].clone())
                want.append(getattr(out_k, name))
    for key, names in (("target feeds", ("out_a_t", "out_b_t")),
                       ("loudspeaker feeds", ("out_a", "out_b"))):
        worst[key] = max(_rel(torch.stack(feeds[name][0][k::MULTI_N]),
                              torch.stack(feeds[name][1][k::MULTI_N]))[1]
                         for name in names for k in range(MULTI_N))
    alone = [i + 1 for i, d in enumerate(decisions)
             if i >= NEWTON_ONSET and d[1] and not any(d[:1] + d[2:])]
    silenced = model.silenced.tolist()
    print(f"[phase 3 multi] {label}: {MULTI_N} scenes graphed, {NEWTON_HOPS} hops of a periodic "
          f"input, scene 1's +40 dB onset at hop {NEWTON_ONSET + 1}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; launches a hop {({k: v for k, v in counts.items() if v})} (batched = single); "
          f"decisions per hop and scene {[''.join('R' if r else '.' for r in d) for d in decisions]}"
          f" (each scene's own); scene 1 alone rebuilt on hops {alone}; silenced {silenced}; "
          f"capture s {_capture_s(model)} card={card}", flush=True)
    if worst["graph against eager"] != 0.0:
        raise AssertionError(f"multi {label}: the graphed batched hop is not the eager one bit "
                             f"for bit ({worst['graph against eager']:.3e})")
    _check(f"multi {label} statistics", worst["statistics"], TOL_STATS)
    _check(f"multi {label} target feeds", worst["target feeds"], TOL_MULTI_TARGET)
    if not alone:
        raise AssertionError(f"multi {label}: the onset rebuilt scene 1 alone on no hop")
    if any(silenced):
        raise AssertionError(f"multi {label}: silenced {silenced}")
    if counts != _want("solve", 1):
        raise AssertionError(f"multi {label}: launches {counts}")
    return worst["loudspeaker feeds"]


# ---- phase 3, sharding: ranks of a gloo group on the one card --------------

SHARD_RANKS = 2
SHARD_HOPS = 8
SHARD_TIMEOUT_S = 900.0
# The 32-speaker mic-sharded scene, the JAX package's own scaling test
# (tests/test_sharding.py::test_mic_sharded_tpu_scale_jl1600) and its bars.
SHARD32 = {"num_mics": 32, "subspace_oversample": 14, "subspace_iters": 2}
SHARD32_STAT_RTOL, SHARD32_STAT_ATOL = 1e-4, 1e-6  # atol of the buffer's max
SHARD32_FEED_RTOL, SHARD32_FEED_ATOL = 1e-2, 3e-2  # atol of the feeds' scale


def _exceeds(got, want, rtol, atol) -> float:
    """The largest excess of |got - want| over atol + rtol |want| (<= 0 when
    within), with the difference's max printed beside it."""
    diff = (got.double() - want.double()).abs()
    return float((diff - (atol + rtol * want.double().abs())).max())


def _shard_eager_ms(times):
    """A rank's eager host-clock times: the first hop (caches, plans) and
    the median of the rest."""
    rest = sorted(times[1:])
    return (f"eager ms/hop: hop 1 {1e3 * times[0]:.3f}, median of hops 2-{len(times)} "
            f"{1e3 * rest[len(rest) // 2]:.3f} (host clock, synchronized; printed, not gated)")


def _shard_mic_td(rank, dev, card):
    """(a) The 32-speaker scene (JL = 1600) over a mic mesh of the ranks:
    SHARD_HOPS hops, each held against the unsharded hop on the card from
    the same (gathered) state: ``wresp_stat`` to rtol 1e-4, atol 1e-6 of its
    max; the loudspeaker feeds finite and within rtol 1e-2, atol 3e-2 of
    scale (the JAX package's bars)."""
    from apvast_torch.config import GevdSolver
    from apvast_torch.engine import build_plan, init_state
    from apvast_torch.ops import kernels as K
    from apvast_torch.ops.collective import mic_sum
    from apvast_torch.parallel.mesh import (
        gather_blocks, make_mesh, shard_plan, shard_scene_batch, sharded_multi_scene_hop,
        stack_plans, stack_states)
    from apvast_torch.utils.scenes import scale_scene

    scene = scale_scene(32, gevd_solver=GevdSolver.SUBSPACE, **SHARD32)
    cfg = scene.config
    plan = stack_plans([build_plan(cfg, scene.rir_a, scene.rir_b, dev)])
    state = stack_states([init_state(cfg, dev, generator=torch.Generator().manual_seed(2))])
    mesh = make_mesh({"mic": SHARD_RANKS})
    sp, ss = shard_plan(plan, mesh), shard_scene_batch(state, mesh)
    fn, whole = sharded_multi_scene_hop(cfg, mesh), sharded_multi_scene_hop(cfg)
    x = torch.as_tensor(np.random.default_rng(SEED + 32).standard_normal(
        (SHARD_HOPS, 2, 1, cfg.hop)).astype(np.float32)).to(dev)
    stat_excess = feed_excess = -np.inf
    times, counts = [], {}
    for i in range(SHARD_HOPS):
        before = gather_blocks(ss, mesh)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ss, out = fn(sp, ss, x[i, 0], x[i, 1])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = K.launch_counts()
        got = gather_blocks(ss, mesh)
        want_state, want = whole(plan, before, x[i, 0], x[i, 1])
        stat = want_state.wresp_stat
        stat_excess = max(stat_excess, _exceeds(got.wresp_stat, stat, SHARD32_STAT_RTOL,
                                                SHARD32_STAT_ATOL * float(stat.abs().max())))
        for name in ("out_a", "out_b"):
            g, w = getattr(out, name), getattr(want, name)
            if not torch.isfinite(g).all():
                raise AssertionError(f"shard mic td rank {rank} hop {i + 1}: non-finite {name}")
            feed_excess = max(feed_excess, _exceeds(g, w, SHARD32_FEED_RTOL,
                                                    SHARD32_FEED_ATOL * float(w.abs().max())))
    # The hop's one collective alone: the (4, JL, JL) statistics summed
    # over the mic group through the host.
    r_mats = torch.ones((4, cfg.jl, cfg.jl), device=dev)
    reduce_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mic_sum(r_mats, mesh.group("mic"))
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
    print(f"[phase 3 shard] rank {rank} (a) TD, mic mesh {mesh.shape}, scale_scene(32, "
          f"num_mics=32) JL={cfg.jl}, {SHARD_HOPS} hops each against the unsharded hop from the "
          f"same state: wresp_stat excess over its bar {stat_excess:.3e}, loudspeaker feeds "
          f"excess {feed_excess:.3e} (<= 0 passes); launches {({k: v for k, v in counts.items() if v})}"
          f"; {_shard_eager_ms(times)}; the statistics' all-reduce alone "
          f"{1e3 * min(reduce_s):.3f} ms (best of 3) card={card}", flush=True)
    if stat_excess > 0 or feed_excess > 0:
        raise AssertionError(f"shard mic td rank {rank}: outside the bars")


def _shard_scene_td(rank, dev, card, sweeps=None):
    """(b) Four production scenes of ``scale_scene(16)`` over a scene mesh,
    two a rank, SHARD_HOPS hops, each rank's hop held against the
    single-process batched hop of its own two scenes from the same state:
    statistics TOL_STATS, target feeds TOL_MULTI_TARGET, and (with
    ``sweeps``, K4 converged) loudspeaker feeds TOL_FEEDS; every kernel of
    the path once a hop."""
    from apvast_torch import production_overrides
    from apvast_torch.engine import build_plan, hop_statistics, init_state
    from apvast_torch.engine.graph import clone_state
    from apvast_torch.ops import kernels as K
    from apvast_torch.parallel.mesh import (
        make_mesh, scene_block, shard_plan, shard_scene_batch, sharded_multi_scene_hop,
        stack_plans, stack_states)
    from apvast_torch.utils.scenes import scale_scene

    extra = {} if sweeps is None else {"jacobi_sweeps": sweeps}
    scene = scale_scene(16, **(production_overrides() | extra))
    cfg = scene.config
    pairs = _scene_pairs(scene, MULTI_N)
    plans = stack_plans([build_plan(cfg, a, b, dev) for a, b in pairs])
    states = stack_states([init_state(cfg, dev, generator=torch.Generator().manual_seed(i))
                           for i in range(MULTI_N)])
    mesh = make_mesh({"scene": SHARD_RANKS})
    sp, ss = shard_plan(plans, mesh), shard_scene_batch(states, mesh)
    fn, block = sharded_multi_scene_hop(cfg, mesh), sharded_multi_scene_hop(cfg)
    x = _multi_inputs(cfg, dev, SHARD_HOPS, MULTI_N)
    stats_fn = torch.func.vmap(lambda w, t: hop_statistics(cfg, w, t))
    worst = {"statistics": 0.0, "target feeds": 0.0, "loudspeaker feeds": 0.0}
    times, rebuilt = [], []
    for i in range(SHARD_HOPS):
        before = clone_state(ss)
        xa, xb = scene_block(x[0, i], mesh), scene_block(x[1, i], mesh)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ss, out = fn(sp, ss, xa, xb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = K.launch_counts()
        if counts != _want("production", 1):
            raise AssertionError(f"shard scene td rank {rank} hop {i + 1}: launches {counts}")
        rebuilt.append(out.rebuilt)
        want_state, want = block(sp, before, xa, xb)
        if want.rebuilt != out.rebuilt:
            raise AssertionError(f"shard scene td rank {rank} hop {i + 1}: rebuild decisions "
                                 f"differ ({out.rebuilt}, {want.rebuilt})")
        for a, b in zip(stats_fn(ss.wresp_stat, ss.wtarget_stat),
                        stats_fn(want_state.wresp_stat, want_state.wtarget_stat)):
            worst["statistics"] = max(worst["statistics"], _rel(a, b)[1])
        for key, names in (("target feeds", ("out_a_t", "out_b_t")),
                           ("loudspeaker feeds", ("out_a", "out_b"))):
            for name in names:
                worst[key] = max(worst[key], _rel(getattr(out, name), getattr(want, name))[1])
    label = "configured" if sweeps is None else f"{sweeps} sweeps"
    print(f"[phase 3 shard] rank {rank} (b) TD, scene mesh {mesh.shape}, production "
          f"({label}), scenes {mesh.coordinate('scene') * 2}-{mesh.coordinate('scene') * 2 + 1} "
          f"of {MULTI_N}, {SHARD_HOPS} hops each against the batched hop of the same two scenes "
          f"from the same state: " + ", ".join(f"{k} rel_err {v:.3e}" for k, v in worst.items())
          + f"; rebuilds {rebuilt}; launches a hop {({k: v for k, v in counts.items() if v})}; "
          f"{_shard_eager_ms(times)} card={card}", flush=True)
    _check(f"shard scene td rank {rank} statistics", worst["statistics"], TOL_STATS)
    _check(f"shard scene td rank {rank} target feeds", worst["target feeds"], TOL_MULTI_TARGET)
    if sweeps is not None:
        _check(f"shard scene td rank {rank} loudspeaker feeds", worst["loudspeaker feeds"],
               TOL_FEEDS)


def _shard_mic_fd(rank, dev, card):
    """(c) The FD engine (fd-jacobi settings, the FFT convolution: K1 folds
    every microphone) on ``scale_scene(16, num_mics=16)`` over a mic mesh:
    SHARD_HOPS hops, each held against the unsharded FD hop from the same
    (gathered) state: cov and cross within TOL_STATS of scale; K7 once a
    hop."""
    from apvast_torch.engine import build_plan, init_fd_state
    from apvast_torch.ops import kernels as K
    from apvast_torch.parallel.mesh import (
        gather_blocks, make_mesh, shard_fd_state, shard_plan, sharded_multi_scene_fd_hop,
        stack_plans, stack_states)
    from apvast_torch.utils.scenes import scale_scene

    s = 16
    scene = scale_scene(s, num_mics=16, num_eigenvectors=s, fd_jacobi_sweeps=FD_SWEEPS,
                        fd_eigh="jacobi", use_matmul_dft=True, use_pallas_conv=False)
    cfg = scene.config
    plan = stack_plans([build_plan(cfg, scene.rir_a, scene.rir_b, dev)])
    state = stack_states([init_fd_state(cfg, dev, generator=torch.Generator().manual_seed(3))])
    mesh = make_mesh({"mic": SHARD_RANKS})
    sp, ss = shard_plan(plan, mesh), shard_fd_state(state, mesh)
    fn = sharded_multi_scene_fd_hop(cfg, mesh, forgetting=FD_FORGETTING)
    whole = sharded_multi_scene_fd_hop(cfg, forgetting=FD_FORGETTING)
    x = torch.as_tensor(np.random.default_rng(SEED + 16).standard_normal(
        (SHARD_HOPS, 2, 1, cfg.hop)).astype(np.float32)).to(dev)
    worst = {"cov": 0.0, "cross": 0.0}
    times = []
    for i in range(SHARD_HOPS):
        before = gather_blocks(ss, mesh)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ss, out = fn(sp, ss, x[i, 0], x[i, 1])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = K.launch_counts()
        if counts != {name: int(name in FD_KERNELS) for name in K.WRAPPERS}:
            raise AssertionError(f"shard mic fd rank {rank} hop {i + 1}: launches {counts}")
        want_state, _ = whole(plan, before, x[i, 0], x[i, 1])
        for name in worst:
            worst[name] = max(worst[name], _rel(getattr(ss, name), getattr(want_state, name))[1])
        if not torch.isfinite(out.out_a).all() or int(out.silenced.sum()):
            raise AssertionError(f"shard mic fd rank {rank} hop {i + 1}: unhealthy outputs")
    print(f"[phase 3 shard] rank {rank} (c) FD fd-jacobi, mic mesh {mesh.shape}, "
          f"scale_scene(16, num_mics=16), {SHARD_HOPS} hops each against the unsharded FD hop "
          f"from the same state: " + ", ".join(f"{k} rel_err {v:.3e}" for k, v in worst.items())
          + f"; launches a hop {({k: v for k, v in counts.items() if v})}; "
          f"{_shard_eager_ms(times)} card={card}", flush=True)
    for name, rel in worst.items():
        _check(f"shard mic fd rank {rank} {name}", rel, TOL_STATS)


def _shard_rank(rank, store, card):
    """One rank of ``[phase 3 shard]``: joins the gloo group (a file store),
    runs (a), (b) configured and at CONVERGED_SWEEPS, and (c) on the card;
    a failed check raises, and the rank's process exits non-zero."""
    import os

    import torch.distributed as dist

    # Gloo's pairs connect over loopback: the machine may have no other
    # interface.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=SHARD_RANKS)
    try:
        _shard_mic_td(rank, dev, card)
        _shard_scene_td(rank, dev, card)
        _shard_scene_td(rank, dev, card, sweeps=CONVERGED_SWEEPS)
        _shard_mic_fd(rank, dev, card)
    finally:
        dist.destroy_process_group()


def phase3_shard(card):
    """Sharding (see the module docstring): SHARD_RANKS processes on the one
    card in a gloo group (NCCL refuses two ranks on one device), spawned,
    joined within SHARD_TIMEOUT_S, every process ended before returning; a
    rank's failure fails the phase."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        context = mp.start_processes(_shard_rank, args=(os.path.join(tmp, "store"), card),
                                     nprocs=SHARD_RANKS, join=False, start_method="spawn")
        try:
            while not context.join(timeout=5.0):
                if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                    raise AssertionError(f"[phase 3 shard] ranks still running after "
                                         f"{SHARD_TIMEOUT_S:.0f} s")
        finally:
            for p in context.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
    print(f"[phase 3 shard] {SHARD_RANKS} ranks passed (a), (b) and (c) in "
          f"{time.perf_counter() - t0:.1f} s card={card}", flush=True)


# ---- phase 3, the kept lag assemblies and the c0 methods --------------------

LAG_ASSEMBLIES = ("pair", "wide", "tap")
C0_METHODS = ("auto", "conv", "matmul", "fft")


def _lag_c0(dev, card):
    """Each c0_method at the north-star shapes (4, 17, 16, 999), J = 50,
    against the float64 correlations on the card (1e-4 of scale), timed."""
    from apvast_torch.ops import kernels as K
    from apvast_torch.ops import lag_statistics as L

    j = 50
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((4, 17, 16, 999), generator=g, device=dev)
    oracle = L._c0_conv(x.double(), 999 - j + 1)
    flush = torch.empty(64 * 2**20 // 4, device=dev)
    for method in C0_METHODS:
        K.reset_launch_counts()
        got = L._compute_c0(x, j, method)
        launches = K.launch_counts()["lag_corr"]
        rel = _rel(got, oracle)[1]
        ms = _time_ms(lambda m=method: L._compute_c0(x, j, m), 10, flush)
        print(f"[phase 3 lag] c0_method={method!r} {tuple(x.shape)}, J={j}: rel_err {rel:.3e} "
              f"against float64, {ms:.4f} ms (CUDA events, L2 flushed), K2 launches {launches} "
              f"card={card}", flush=True)
        if (launches == 1) != (method == "auto"):
            raise AssertionError(f"c0_method={method!r}: {launches} K2 launches")
        _check(f"c0_method={method!r}", rel, TOL_KERNEL)


def phase3_lag(scene, dev, card):
    """The pair, wide and tap assemblies (full form, C0 by K2) on the
    production path: 64 hops each (``drive``: launches, silenced 0, the
    first CPU_HOPS hops' statistics and target feeds against the CPU, the
    contrast), the statistics of the final state against the skew
    assembly's (full form) from that state (1e-4, the tap-major ones
    permuted source-major); then the c0 methods."""
    from apvast_torch import production_overrides
    from apvast_torch.engine import hop_statistics
    from apvast_torch.engine.graph import clone_state

    noise, sig = _inputs(scene)
    skew_cfg = dataclasses.replace(scene.config, **(production_overrides()
                                                    | {"statistics_half_form": False}))
    s, j = scene.config.num_srcs, scene.config.filter_length
    for assembly in LAG_ASSEMBLIES:
        overrides = production_overrides() | {"lag_assembly": assembly}
        model = drive(scene, dev, card, f"{assembly}-assembly", overrides,
                      _want(assembly, HOPS), sig, noise, gate_feeds=False)[0]
        if not model.graphed:
            raise AssertionError(f"{assembly}-assembly: not graphed ({model.eager_reason})")
        state = clone_state(model.state)
        r, v = hop_statistics(model.config, state.wresp_stat, state.wtarget_stat)
        if assembly == "tap":  # tap-major (t, s) -> source-major (s, t)
            r = r.reshape(4, j, s, j, s).permute(0, 2, 1, 4, 3).reshape(4, s * j, s * j)
            v = v.reshape(2, j, s).transpose(1, 2).reshape(2, s * j)
        want_r, want_v = hop_statistics(skew_cfg, state.wresp_stat, state.wtarget_stat)
        rel = max(_rel(r, want_r)[1], _rel(v, want_v)[1])
        print(f"[phase 3 lag] {assembly}-assembly: statistics of the state after {HOPS} hops "
              f"against the skew assembly's (full form) from that state: rel_err {rel:.3e}; "
              f"silenced {int(model.silenced)} card={card}", flush=True)
        _check(f"{assembly}-assembly statistics against skew", rel, TOL_STATS)
        del model
    _lag_c0(dev, card)

# ---- phase 3, the 32-speaker scene: scale_scene(32), JL = 1600 -------------

# BASELINE.json config 5, the JAX package's one-chip scaling scene
# (tools/tracking_gate.py, tools/resid_profile.py): S = 32, M = 33, J = 50,
# JL = 1600, V = 50, k = 64, widths not cut. A CPU hop at JL = 1600 takes
# seconds, so SCALE32_CPU_HOPS hops are held against the CPU.
SCALE32_SRCS = 32
SCALE32_CPU_HOPS = 2
SCALE32_GRAPH_HOPS = 16  # graphed against eager, from one state
# tools/resid_profile.py's experiment: both programs +20 dB from the 0-based
# hop SCALE32_STEP_HOP on; a residual-triggered rebuild on one of the
# SCALE32_STEP_WITHIN hops that follow the step's first hop.
SCALE32_STEP_HOP = 39
SCALE32_STEP_GAIN = 10.0
SCALE32_STEP_WITHIN = 2


def phase2_scale32(scene, dev, card, results):
    """K1, K2, K3 (half form) and K5 at the 32-speaker scene's shapes
    against their plain versions (TOL_KERNEL of scale), timed as phase 2
    times them (CUDA events, L2 flushed, the card spinning while the host
    enqueues), beside their bounds (as phase 2 counts them) and library
    calls; added to each kernel's row of ``results`` under ``scale32_*``."""
    from apvast_torch.engine.plan import build_plan

    cfg = scene.config
    plan = build_plan(cfg, scene.rir_a, scene.rir_b, dev)
    g = torch.Generator().manual_seed(SEED + SCALE32_SRCS)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    flush = torch.zeros(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    rows_by_name = {r["name"]: r for r in results}
    for name, c in _stream_cases(cfg, plan, rnd).items():
        errs = _errs(c["kernel"](), c["plain"]())
        torch.cuda.synchronize()
        max_abs, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        _check(f"{name} (32-speaker shape)", rel, TOL_KERNEL)
        kernel_ms = _time_ms(c["kernel"], 50, flush)
        plain_ms = _time_ms(c["plain"], 10, flush)
        library_ms = _time_ms(c["library"], 50, flush) if c["library"] else None
        bound_ms, bound_by, _ = _bound(c["flops"], c["bytes"], c.get("tc_flops"))
        print(f"[phase 2 scale32] {name} {c['shape']}: rel_err={rel:.3e} "
              f"max_abs_err={max_abs:.3e} kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms if library_ms is None else f'{library_ms:.5f}'} "
              f"bound_us={bound_ms * 1e3:.2f} ({bound_by}) "
              f"roofline_share={bound_ms / kernel_ms:.3f} card={card}", flush=True)
        rows_by_name[name].update(
            scale32_ms=kernel_ms, scale32_plain_ms=plain_ms, scale32_library_ms=library_ms,
            scale32_bound_ms=bound_ms, scale32_bound_by=bound_by, scale32_max_abs_err=max_abs)


def _scale32_residual_step(scene, dev, card, noise, sig):
    """tools/resid_profile.py on the card: the graphed production path for
    HOPS hops with both programs SCALE32_STEP_GAIN times louder from hop
    SCALE32_STEP_HOP on. Prints every hop's tracking residual and why each
    rebuild happened (warmup, period or residual, by the rebuild predicate
    on the host), and the stationary band (the residual of the non-rebuild
    hops after the warmup and before the step). Gates: silenced 0, and a
    residual-triggered rebuild within SCALE32_STEP_WITHIN hops of the step.
    Stationary hops above the threshold are reported as a finding, not
    gated: the threshold stays the JAX package's."""
    from apvast_torch import production_overrides

    model = _model(scene, dev, noise, production_overrides())
    if not model.graphed:
        raise AssertionError(f"production-32: not graphed ({model.eager_reason})")
    cfg = model.config
    stepped = sig.copy()
    stepped[:, SCALE32_STEP_HOP * cfg.hop:] *= SCALE32_STEP_GAIN
    x = torch.as_tensor(stepped).to(dev).reshape(2, HOPS, -1)
    threshold, warmup = cfg.tracking_residual_rebuild, cfg.tracking_warmup_hops
    period = cfg.tracking_rebuild_period
    resid, reasons = [], []
    for i in range(HOPS):
        gevd_hop, rebuilds = model.state.gevd_hop, model.rebuilds
        model.process_input_buffers(x[0, i], x[1, i])
        resid.append(float(model.state.gevd_resid))
        if model.rebuilds == rebuilds:
            reasons.append(None)
        elif gevd_hop < warmup:
            reasons.append("warmup")
        elif gevd_hop % period == 0:
            reasons.append("period")
        else:
            reasons.append("residual")
    silenced = int(model.silenced.item())
    stationary = [i for i in range(warmup, SCALE32_STEP_HOP) if reasons[i] is None]
    band = sorted(resid[i] for i in stationary)
    above = [i + 1 for i in stationary if resid[i] > threshold]
    triggered = [i + 1 for i, why in enumerate(reasons) if why == "residual"]
    in_window = [h for h in triggered
                 if SCALE32_STEP_HOP + 1 < h <= SCALE32_STEP_HOP + 1 + SCALE32_STEP_WITHIN]
    print(f"[phase 3 scale32] residual step: production graphed, {HOPS} hops, both programs "
          f"+20 dB from hop {SCALE32_STEP_HOP + 1}; threshold {threshold}, period {period}, "
          f"warmup {warmup}; per hop (hop: residual, rebuild reason): "
          + ", ".join(f"{i + 1}: {r:.4f}{'' if why is None else ' ' + why}"
                      for i, (r, why) in enumerate(zip(resid, reasons)))
          + f"; silenced {silenced} card={card}", flush=True)
    print(f"[phase 3 scale32] residual step: stationary band (hops {warmup + 1}-"
          f"{SCALE32_STEP_HOP} without a rebuild, {len(band)} hops) min {band[0]:.4f} median "
          f"{band[len(band) // 2]:.4f} max {band[-1]:.4f}; step: residual "
          f"{resid[SCALE32_STEP_HOP]:.4f} on hop {SCALE32_STEP_HOP + 1}; residual-triggered "
          f"rebuilds on hops {triggered}, within {SCALE32_STEP_WITHIN} hops of the step "
          f"{in_window}", flush=True)
    if above:
        print(f"[phase 3 scale32] FINDING: stationary hops {above} read a residual above the "
              f"threshold {threshold} (reported, not gated; the threshold stays {threshold})",
              flush=True)
    if silenced:
        raise AssertionError(f"residual step: silenced {silenced}")
    if not in_window:
        raise AssertionError(f"residual step: no residual-triggered rebuild within "
                             f"{SCALE32_STEP_WITHIN} hops of the step (residual-triggered: "
                             f"{triggered})")


def _device_mib(build):
    """``build()``'s peak device memory and what stays allocated while its
    result lives, in MiB above what was allocated before."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kept = build()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    return kept, peak, (torch.cuda.memory_allocated() - base) / 2**20


def phase3_scale32(scene, dev, card, results):
    """The 32-speaker scene through the production path (see the module
    docstring). Returns, for phase 4, the production and the invert path's
    eager and graphed models, inputs and ms/hop by label."""
    from apvast_torch import GevdSolver, production_overrides

    t_phase = time.perf_counter()
    tag = "phase 3 scale32"
    cfg = scene.config
    prod_cfg = production_overrides()
    print(f"[{tag}] {scene.name}: S={cfg.num_srcs} M={cfg.num_mics} J={cfg.filter_length} "
          f"JL={cfg.jl} V={cfg.num_eigenvectors} "
          f"k={cfg.num_eigenvectors + prod_cfg['subspace_oversample']} "
          f"block={cfg.block_size} hop={cfg.hop} buffer={cfg.statistics_buffer_length} "
          f"perceptual={cfg.perceptual} {cfg.dtype}", flush=True)
    noise, sig = _inputs(scene)
    held = functools.partial(configured_then_converged, scene, dev, card, sig, noise,
                             cpu_hops=SCALE32_CPU_HOPS)
    # K10a factors the dark matrices only while JL pads to at most 1024 (the
    # JAX engine's rule, engine/hop.py): at JL = 1600 'invert' factors them
    # with torch's Cholesky, and K9 runs at n = 1600.
    panels = -(-cfg.jl // 128)
    whiten = panels * HOPS if panels * 128 <= 1024 else 0
    prod = held("production-32", prod_cfg, _want("production", HOPS))
    invert = held("invert-32", prod_cfg | INVERT, _want("invert", HOPS, whiten=whiten))
    exact = drive(scene, dev, card, "exact-32", prod_cfg | {"gevd_solver": GevdSolver.EIGH},
                  _want("exact", HOPS), sig, noise, cpu_hops=SCALE32_CPU_HOPS)
    for label, path in (("production-32", prod), ("invert-32", invert)):
        if not path[0].graphed:
            raise AssertionError(f"{label}: not graphed ({path[0].eager_reason})")
    _contrast_gates(scene, [("production-32", prod, "exact-32", exact),
                            ("invert-32", invert, "exact-32", exact)], tag)
    for r in results:
        n = (invert if r["name"] in ROUND3_KERNELS else prod)[4].get(r["name"], 0)
        if n:
            r["scale32_launches"] = n
    del prod, invert, exact

    x = torch.as_tensor(sig).to(dev).reshape(2, HOPS, -1)
    worst = _graph_against_eager(scene, dev, card, "production", noise, x,
                                 hops=SCALE32_GRAPH_HOPS)
    if any(diff != 0 for _, diff in worst.values()):
        raise AssertionError(f"production-32: the graphed hop is not the eager hop bit for bit "
                             f"({worst})")
    _scale32_residual_step(scene, dev, card, noise, sig)

    def one_stream(label):
        model = _path_model(scene, dev, noise, label, None)
        for i in range(TIME_WARM):
            model.process_input_buffers(x[0, i], x[1, i])
        return model

    for label in ("production", "invert"):
        _, peak, kept = _device_mib(functools.partial(one_stream, label))
        print(f"[{tag}] {label}-32, one stream graphed, {TIME_WARM} hops: device memory peak "
              f"{peak:.1f} MiB, {kept:.1f} MiB allocated while it lives "
              f"(torch.cuda.max_memory_allocated) card={card}", flush=True)
    timed = {f"{label}-32": _eager_graphed_ms(scene, dev, card, noise, x, label, tag)
             for label in ("production", "invert")}
    print(f"[{tag}] graphed: production-32 {timed['production-32'][4]:.3f} ms/hop, invert-32 "
          f"{timed['invert-32'][4]:.3f} ms/hop against the {REALTIME_MS:.2f} ms real-time limit "
          f"of one stream (host clock; measurements, not gates) card={card}", flush=True)

    pairs = _scene_pairs(scene, MULTI_N)
    feeds = _multi_held(scene, dev, card, pairs, "production")
    print(f"[{tag}] multi production-32: loudspeaker feeds rel_err {feeds:.3e} at "
          f"{prod_cfg['jacobi_sweeps']} sweeps (printed; gated at {CONVERGED_SWEEPS} sweeps)",
          flush=True)
    _check("multi production-32 loudspeaker feeds",
           _multi_held(scene, dev, card, pairs, "production", jacobi_sweeps=CONVERGED_SWEEPS),
           TOL_FEEDS)
    (_, _, ms), peak, kept = _device_mib(
        lambda: _multi_time(scene, dev, card, pairs, "production", MULTI_N))
    print(f"[{tag}] multi production-32 N={MULTI_N}: {ms:.3f} ms per batched hop, "
          f"{MULTI_N * REALTIME_MS / ms:.2f} streams per card; device memory peak {peak:.1f} MiB "
          f"({peak / MULTI_N:.1f} a stream) card={card}", flush=True)
    print(f"[{tag}] took {time.perf_counter() - t_phase:.1f} s card={card}", flush=True)
    return timed


# ---- phase 3, the demo: examples/run_demo_torch.py --------------------------

DEMO_HOPS = 20
DEMO_FLAGS = {"exact": (), "fast": ("--fast",), "fd": ("--fd",)}
DEMO_FAST_KERNELS = ("streaming_conv", "output_filter", "statistics")
TOL_DEMO_NMSE = 5e-2  # relative, the card's run against the CPU's


def phase3_demo(card):
    """The port's demo (``examples/run_demo_torch.py``) in this process at
    DEMO_HOPS hops on the card, for the default (the exact solver),
    ``--fast`` and ``--fd``, each against the same demo with ``--cpu``:
    every span's zone contrast within TOL_CONTRAST_DB and NMSE within
    TOL_DEMO_NMSE relative; ``--fast`` launches K1, K5 and K6; wall seconds
    printed."""
    import importlib.util
    import os

    from apvast_torch.ops import kernels as K

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "run_demo_torch.py")
    spec = importlib.util.spec_from_file_location("run_demo_torch", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    for label, flags in DEMO_FLAGS.items():
        argv = ["--hops", str(DEMO_HOPS), *flags]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        on_card = demo.run(demo.parse_args(argv))
        card_s = time.perf_counter() - t0
        counts = K.launch_counts()
        t0 = time.perf_counter()
        on_cpu = demo.run(demo.parse_args([*argv, "--cpu"]))
        cpu_s = time.perf_counter() - t0
        if on_card["device"] != "cuda" or on_cpu["device"] != "cpu":
            raise AssertionError(f"demo {label}: ran on {on_card['device']} / {on_cpu['device']}")
        worst_db = worst_nmse = 0.0
        for got, want in zip(on_card["rows"], on_cpu["rows"]):
            worst_db = max(worst_db, abs(got[1] - want[1]), abs(got[2] - want[2]))
            worst_nmse = max(worst_nmse,
                             *(abs(g - w) / abs(w) for g, w in zip(got[3:5], want[3:5])))
            print(f"[phase 3 demo] {label} span {got[0]}: card contrast A {got[1]:.4f} B "
                  f"{got[2]:.4f} dB, NMSE A {got[3]:.4f} B {got[4]:.4f}, detectability "
                  f"{got[5]:.3e};"
                  f" cpu {want[1]:.4f} {want[2]:.4f} dB, {want[3]:.4f} {want[4]:.4f}, "
                  f"{want[5]:.3e}", flush=True)
        print(f"[phase 3 demo] {label} ({' '.join(argv)}): card against --cpu: contrast "
              f"{worst_db:.4f} dB (limit {TOL_CONTRAST_DB}), NMSE {worst_nmse:.3e} relative "
              f"(limit {TOL_DEMO_NMSE}); launches {({k: v for k, v in counts.items() if v})}; "
              f"wall s: card {card_s:.2f} (stream {on_card['seconds']:.2f}), cpu {cpu_s:.2f} "
              f"(stream {on_cpu['seconds']:.2f}) card={card}", flush=True)
        if worst_db > TOL_CONTRAST_DB or worst_nmse > TOL_DEMO_NMSE:
            raise AssertionError(f"demo {label}: the card's table is not the CPU's")
        if label == "fast" and not all(counts[name] for name in DEMO_FAST_KERNELS):
            raise AssertionError(f"demo --fast: launches {counts}, want {DEMO_FAST_KERNELS}")

# ---- phase 3, evaluation: metrics, checkpoints, MATLAB, bf16, offline ------

TOL_METRICS = 1e-4  # the card's per-hop metrics against the CPU's float64
# _spectral_norm (the JAX package's 12 power steps on R^2) against the exact
# 2-norm: the JAX package's own bar on covariance matrices, whose top
# eigenvalues form a plateau the steps converge into
# (tests/test_subspace_solver.py::test_spectral_norm_matches_exact); 1% holds
# only on its clustered synthetic matrix.
TOL_SPECTRAL_NORM = 5e-2
TOL_OFFLINE = 1e-6  # the offline sweep in float64, card against CPU
SAVE_AT, RESUME_TO = 32, 48  # checkpoint after hop 32, resume hops 33-48
OFFLINE_STEPS = 1000
OFFLINE_MU = (0.01, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0)


def matlab_overrides():
    """The MATLAB configuration of tests/test_matlab_variants.py on the
    production values, in full form (the norm-scaled loading needs the
    completed matrices); perceptual weighting is the scene's (on)."""
    from apvast_torch import production_overrides
    from apvast_torch.config import (
        RegularizationVariant,
        TargetFilterVariant,
        ToeplitzVariant,
        WeightingNorm,
    )

    return production_overrides() | {
        "statistics_half_form": False,
        "toeplitz_variant": ToeplitzVariant.MATLAB,
        "normalize_statistics": True,
        "regularization": RegularizationVariant.MATLAB,
        "weighting_norm": WeightingNorm.UNIT_SYMMETRIC,
        "target_filter": TargetFilterVariant.PER_ZONE,
    }


def _nan_rel(got, want) -> float:
    """_rel over the finite entries, after requiring the same NaN pattern."""
    got, want = got.double().cpu(), want.double().cpu()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError("NaN patterns differ")
    keep = ~torch.isnan(want)
    return _rel(got[keep], want[keep])[1] if keep.any() else 0.0


def _eval_metrics(scene, dev, card, noise, sig):
    """run_stream_with_metrics on production, graphed, for HOPS hops: its
    metrics against hop_metrics of the same feeds on the CPU in float64,
    the rank-1 zone-A contrast of hops 7-64, and ms/hop against
    run_stream."""
    from apvast_torch import production_overrides
    from apvast_torch.engine import build_plan, init_state
    from apvast_torch.engine.hop import HopOutputs
    from apvast_torch.engine.stream import _drive, run_stream_with_metrics
    from apvast_torch.observability import HopMetrics, hop_metrics

    cfg = dataclasses.replace(scene.config, **production_overrides())
    plan = build_plan(cfg, scene.rir_a, scene.rir_b, dev)
    state = init_state(cfg, dev, response_noise=noise)
    x = torch.as_tensor(sig).to(dev)
    final, outs, metrics = run_stream_with_metrics(cfg, plan, state, x[0], x[1], scene.rir_a,
                                                   scene.rir_b)
    if outs.out_a.shape[0] != HOPS or int(outs.silenced.sum()) != 0:
        raise AssertionError("metrics: the stream did not run HOPS healthy hops")
    t0 = time.perf_counter()
    worst = {}
    for i in range(HOPS):
        hop = HopOutputs(**{name: getattr(outs, name)[i].cpu().double()
                            for name in ("out_a", "out_b", "out_a_t", "out_b_t")},
                         silenced=outs.silenced[i].cpu())
        want = hop_metrics(hop, scene.rir_a, scene.rir_b)
        for f in dataclasses.fields(HopMetrics):
            got = getattr(metrics, f.name)[i]
            if got.device.type != dev.type:
                raise AssertionError(f"metrics {f.name} left the device")
            worst[f.name] = max(worst.get(f.name, 0.0), _nan_rel(got, getattr(want, f.name)))
    print(f"[phase 3 eval] metrics: run_stream_with_metrics, production graphed, {HOPS} hops, "
          f"against hop_metrics on the CPU in float64 ({time.perf_counter() - t0:.1f} s): worst "
          f"rel_err { {k: f'{v:.2e}' for k, v in worst.items()} } (limit {TOL_METRICS:.0e})",
          flush=True)
    for name, rel in worst.items():
        _check(f"metrics {name}", rel, TOL_METRICS)
    rank1 = metrics.contrast_a_db[TAIL_FROM:, 0].cpu()
    print(f"[phase 3 eval] metrics: zone-A rank-1 contrast of hops {TAIL_FROM + 1}-{HOPS}: "
          f"mean {float(rank1.mean()):.4f} dB, min {float(rank1.min()):.4f}, max "
          f"{float(rank1.max()):.4f}; NMSE rank 1 mean {float(metrics.nmse_a[TAIL_FROM:, 0].mean()):.4f}",
          flush=True)
    if not bool((rank1 > 0).all()):
        raise AssertionError("metrics: a zone-A rank-1 contrast of hops 7-64 is not positive")

    # Steady-state host clock of the drivers' own loop (engine.stream._drive,
    # which both run): a stamp after each hop (with the metrics graph of
    # run_stream_with_metrics when ``with_metrics``), hops 9-64, synchronized.
    rir_a, rir_b = (torch.as_tensor(r).to(dev) for r in (scene.rir_a, scene.rir_b))

    def ms_hop(with_metrics):
        stamps = []
        each_hop = (lambda out: hop_metrics(out, rir_a, rir_b)) if with_metrics else None
        _drive(cfg, plan, state, x[0], x[1], each_hop, lambda: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        return (time.perf_counter() - stamps[CPU_HOPS - 1]) / (HOPS - CPU_HOPS) * 1e3

    # Four turns each, in ABBA order; medians, since a turn of a shared
    # host's clock can read several times the others.
    ms = {False: [], True: []}
    for with_metrics in (False, True, True, False) * 2:
        ms[with_metrics].append(ms_hop(with_metrics))
    plain, with_m = float(np.median(ms[False])), float(np.median(ms[True]))
    print(f"[phase 3 eval] metrics: graphed production, host clock, hops {CPU_HOPS + 1}-{HOPS}, "
          f"in turns: run_stream {[round(v, 4) for v in ms[False]]} ms/hop, "
          f"run_stream_with_metrics {[round(v, 4) for v in ms[True]]} ms/hop; median {plain:.4f} "
          f"against {with_m:.4f}, metrics {with_m - plain:+.4f} ms/hop card={card}", flush=True)
    return final


def _resume(scene, dev, card, noise, sig, label, overrides, fd=False):
    """A graphed model run to hop SAVE_AT, saved, run on to RESUME_TO; a
    fresh graphed model loaded from the file runs the same hops: the feeds
    equal bit for bit."""
    import tempfile

    from apvast_torch.engine import FdState
    from apvast_torch.engine.state import ApVastState
    from apvast_torch.utils.checkpoint import load_state, save_state

    def model():
        m = (_fd_model if fd else _model)(scene, dev, noise, overrides)
        if not m.graphed:
            raise AssertionError(f"resume {label}: not graphed ({m.eager_reason})")
        return m

    x = torch.as_tensor(sig).to(dev)
    hop = scene.config.hop

    def run(m, first, last):
        outs = []
        for i in range(first, last):
            outs.append(m.process_input_buffers(x[0, i * hop : (i + 1) * hop],
                                                x[1, i * hop : (i + 1) * hop]))
        return outs

    first = model()
    run(first, 0, SAVE_AT)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/state.npz"
        save_state(path, first.state)
        want = run(first, SAVE_AT, RESUME_TO)
        second = model()
        second.state = load_state(path, second.config, FdState if fd else ApVastState, dev)
    got = run(second, SAVE_AT, RESUME_TO)
    diff = max(float((g - w).abs().max()) for gh, wh in zip(got, want) for g, w in zip(gh, wh))
    minv = getattr(first.state, "gevd_minv", None)
    print(f"[phase 3 eval] resume {label}: saved after hop {SAVE_AT}, hops {SAVE_AT + 1}-"
          f"{RESUME_TO} in a fresh graphed model from the file: max |diff| {diff:.3e} over every "
          f"feed (required 0){'' if minv is None else f'; carry {minv.dtype}'}; silenced "
          f"{int(first.silenced)} / {int(second.silenced)}", flush=True)
    if diff != 0 or int(first.silenced) or int(second.silenced):
        raise AssertionError(f"resume {label}: not bit for bit")


def _eval_matlab(scene, dev, card, noise, sig):
    """The MATLAB configuration on the card (K1, K2, full-form K3, K4, K5):
    held against the CPU as the production path is, silenced 0, its
    contrast; _spectral_norm of its hop's matrices against the exact
    2-norm."""
    from apvast_torch.engine import hop_statistics
    from apvast_torch.engine.hop import _spectral_norm

    want = _want("production", HOPS)
    path = configured_then_converged(scene, dev, card, sig, noise, "matlab", matlab_overrides(),
                                     want)
    model, contrast = path[0], path[5]
    cfg = model.config
    r_mats, _ = hop_statistics(cfg, model.state.wresp_stat, model.state.wtarget_stat)
    worst = {"float64 CPU": 0.0, "exact": 0.0}
    for name, mats in (("A", r_mats[0::3]), ("B", r_mats[1:3])):
        got = _spectral_norm(mats.contiguous()).double().cpu()
        same = _spectral_norm(mats.double().cpu())  # the same 12 steps in float64
        exact = torch.linalg.matrix_norm(mats.double(), ord=2).cpu()
        rel = {"float64 CPU": ((got - same).abs() / same).max().item(),
               "exact": ((got - exact).abs() / exact).max().item()}
        worst = {k: max(worst[k], rel[k]) for k in worst}
        print(f"[phase 3 eval] matlab: _spectral_norm of {name} {tuple(mats.shape)} on the card "
              f"(float32, 12 steps) {got.tolist()}; the same steps in float64 on the CPU "
              f"{same.tolist()}: rel_err {rel['float64 CPU']:.3e} (limit {TOL_KERNEL:.0e}); "
              f"torch.linalg.matrix_norm(ord=2) in float64 {exact.tolist()}: rel_err "
              f"{rel['exact']:.3e} (limit {TOL_SPECTRAL_NORM:.0e})", flush=True)
    print(f"[phase 3 eval] matlab: silenced 0, zone-A contrast over hops {TAIL_FROM + 1}-{HOPS}: "
          f"rank 1 {contrast[0]:.4f} dB, rank {cfg.num_eigenvectors} {contrast[1]:.4f} dB "
          f"card={card}", flush=True)
    _check("matlab _spectral_norm against float64", worst["float64 CPU"], TOL_KERNEL)
    _check("matlab _spectral_norm against the exact norm", worst["exact"], TOL_SPECTRAL_NORM)


def _knob_run(scene, dev, noise, sig, overrides, keep_states=False):
    """A graphed model of ``overrides`` for HOPS hops: the model, per-hop
    silenced, steady-state ms/hop (host clock), zone-A contrast at ranks 1
    and V, whether every loudspeaker feed was finite, and (``keep_states``)
    the state before each hop."""
    from apvast_torch.engine.graph import clone_state

    model = _model(scene, dev, noise, overrides)
    if not model.graphed:
        raise AssertionError(f"not graphed ({model.eager_reason})")
    cfg = model.config
    x = torch.as_tensor(sig).to(dev)
    hop, v = cfg.hop, cfg.num_solutions
    silenced, tail, finite, states = [], [], [], []
    for i in range(HOPS):
        if i == CPU_HOPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if keep_states:
            states.append(clone_state(model.state))
        out = model.process_input_buffers(x[0, i * hop : (i + 1) * hop],
                                          x[1, i * hop : (i + 1) * hop])
        silenced.append(model.silenced.clone())
        finite.append(torch.isfinite(out[0]).all())
        if i >= TAIL_FROM:
            tail.append(out[0][:: v - 1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (HOPS - CPU_HOPS) * 1e3
    per_hop = torch.diff(torch.stack(silenced).cpu(), prepend=torch.zeros(1, dtype=torch.int32))
    return model, per_hop, ms, _contrast(scene, tail), bool(torch.stack(finite).all()), states


def _eval_bf16(scene, dev, card, noise, sig):
    """Production against its two bfloat16 knobs, graphed, HOPS hops each:
    silenced 0 and the tracking_li_bf16 contrast within TOL_CONTRAST_DB of
    production's (rank 1 and rank V); residual precision 'default': its
    contrast printed, its feeds finite, and each hop's silenced count equal
    to the CPU hop's from the card's state; ms/hop of all three."""
    from apvast_torch import production_overrides

    runs = {
        "production": production_overrides(),
        "tracking_li_bf16": production_overrides() | {"tracking_li_bf16": True},
        "residual-default": production_overrides() | {"tracking_residual_precision": "default"},
    }
    res = {label: _knob_run(scene, dev, noise, sig, o, keep_states=label == "residual-default")
           for label, o in runs.items()}
    v = scene.config.num_eigenvectors
    prod = res["production"][3]
    for label, (model, per_hop, ms, contrast, _, _) in res.items():
        carry = model.state.gevd_minv.dtype
        nz = [(i + 1, int(n)) for i, n in enumerate(per_hop) if n]
        print(f"[phase 3 eval] {label}: {HOPS} hops graphed, carry {carry}, silenced "
              f"{int(per_hop.sum())} (hop, count) {nz}, {model.rebuilds} rebuilds, steady state "
              f"{ms:.4f} ms/hop; zone-A contrast over hops {TAIL_FROM + 1}-{HOPS}: rank 1 "
              f"{contrast[0]:.4f} dB ({contrast[0] - prod[0]:+.4f} against production), rank {v} "
              f"{contrast[1]:.4f} dB ({contrast[1] - prod[1]:+.4f}) card={card}", flush=True)
    if int(res["production"][1].sum()) or int(res["tracking_li_bf16"][1].sum()):
        raise AssertionError("production or tracking_li_bf16 silenced a hop")
    if res["tracking_li_bf16"][0].state.gevd_minv.dtype != torch.bfloat16:
        raise AssertionError("tracking_li_bf16: the carry is not bfloat16")
    for rank, b, p in zip((1, v), res["tracking_li_bf16"][3], prod):
        if not abs(b - p) <= TOL_CONTRAST_DB:
            raise AssertionError(f"tracking_li_bf16 contrast at rank {rank}: {b - p:+.4f} dB")
    # residual-default: the TPU's single pass silences hops (its Rayleigh-Ritz
    # matrix on bfloat16 products stops factoring), as the JAX engine does
    # when its DEFAULT products are given bfloat16 operands
    # (tools/residual_default_witness.py; tests/test_torch_matlab_variants.py
    # holds the port's CPU hop to that JAX hop). The gate: every hop's
    # silenced count on the card equals the port's CPU hop's from the card's
    # state, and every feed is finite (the engine's guards).
    model, per_hop, _, _, finite, states = res["residual-default"]
    if not finite:
        raise AssertionError("residual-default: a non-finite feed")
    from apvast_torch.engine import build_plan, process_hop

    x = torch.as_tensor(sig)
    hop = model.config.hop
    plan = build_plan(model.config, scene.rir_a, scene.rir_b, "cpu")
    t0 = time.perf_counter()
    cpu = []
    for i in range(HOPS):
        _, out = process_hop(model.config, plan, _to(states[i], "cpu"),
                             x[0, i * hop : (i + 1) * hop], x[1, i * hop : (i + 1) * hop])
        cpu.append(int(out.silenced))
    differ = [(i + 1, int(c), h) for i, (c, h) in enumerate(zip(per_hop, cpu)) if int(c) != h]
    print(f"[phase 3 eval] residual-default: the CPU hop from the card's state on each of {HOPS} "
          f"hops ({time.perf_counter() - t0:.1f} s) silenced {sum(1 for n in cpu if n)} hops; "
          f"hops where the card and the CPU differ (hop, card, CPU): {differ}", flush=True)
    if differ:
        raise AssertionError(f"residual-default: silenced differs from the CPU on {differ}")


def _offline_contrast(scene, filters):
    """Zone-A contrast (dB) of offline FIR filters (J, S): the full
    responses of both zones to the filters, in float64 on the CPU."""
    from apvast_torch.evaluation import acoustic_contrast_db, predict_pressure

    w = filters.double().cpu()
    w = torch.nn.functional.pad(w, (0, 0, 0, scene.rir_a.shape[0] - 1))
    return float(acoustic_contrast_db(predict_pressure(w, scene.rir_a),
                                      predict_pressure(w, scene.rir_b)))


def _eval_offline(scene, dev, card):
    """vast_offline_sweep on the north star's RIRs (J, num_steps, V, an
    8-value mu grid): float64 on the card against the CPU, the time; the
    BACC and pressure-matching endpoints' contrast in float32 and float64."""
    from apvast_torch.models.vast_offline import acc, pressure_matching, vast_offline_sweep

    c = scene.config
    args = (c.filter_length, c.modeling_delay, c.reference_index_a)
    rir_a64, rir_b64 = (np.asarray(r, np.float64) for r in (scene.rir_a, scene.rir_b))

    def sweep(rb, rd, device):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = vast_offline_sweep(rb, rd, *args, num_eigenvectors=c.num_eigenvectors,
                                 mu_grid=OFFLINE_MU, num_steps=OFFLINE_STEPS, device=device)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    card64, _ = sweep(rir_a64, rir_b64, dev)  # warm-up: cuSOLVER and cuBLAS handles
    card64, ms64 = sweep(rir_a64, rir_b64, dev)
    cpu64, cpu_ms = sweep(rir_a64, rir_b64, "cpu")
    rel = _rel(card64.cpu(), cpu64)[1]
    print(f"[phase 3 eval] offline: vast_offline_sweep {tuple(card64.shape)} (J={c.filter_length}, "
          f"JL={c.jl}, num_steps={OFFLINE_STEPS}, V={c.num_eigenvectors}, mu {list(OFFLINE_MU)}), "
          f"float64: card {ms64:.1f} ms, CPU {cpu_ms:.1f} ms; card against CPU rel_err {rel:.3e} "
          f"(limit {TOL_OFFLINE:.0e}) card={card}", flush=True)
    _check("offline sweep float64", rel, TOL_OFFLINE)
    rir_a32, rir_b32 = (r.astype(np.float32) for r in (rir_a64, rir_b64))
    sweep(rir_a32, rir_b32, dev)  # warm-up: the float32 solver paths
    card32, ms32 = sweep(rir_a32, rir_b32, dev)
    print(f"[phase 3 eval] offline: float32 sweep on the card {ms32:.1f} ms, finite "
          f"{bool(torch.isfinite(card32).all())}, rel_err against float64 "
          f"{_rel(card32.cpu(), cpu64)[1]:.3e}", flush=True)
    for name, fn in (("BACC", acc), ("pressure matching", pressure_matching)):
        c64 = _offline_contrast(scene, fn(rir_a64, rir_b64, *args, num_steps=OFFLINE_STEPS,
                                          device=dev))
        w32 = fn(rir_a32, rir_b32, *args, num_steps=OFFLINE_STEPS, device=dev)
        c32 = (f"{_offline_contrast(scene, w32):.4f} dB" if bool(torch.isfinite(w32).all())
               else "not finite: the unloaded dark matrix does not factor in float32")
        print(f"[phase 3 eval] offline: {name} zone-A contrast, float64 {c64:.4f} dB, float32 "
              f"{c32} (printed, not gated)", flush=True)


def phase3_eval(scene, dev, card):
    """Evaluation and observability, checkpoints, the MATLAB configuration,
    the bfloat16 knobs and offline VAST (see the module docstring)."""
    from apvast_torch import production_overrides

    noise, sig = _inputs(scene)
    _eval_metrics(scene, dev, card, noise, sig)
    s = scene.config.num_srcs
    for label, overrides, fd in (
        ("production", production_overrides(), False),
        ("fd-jacobi", {"number_of_eigenvectors": s, "fd_jacobi_sweeps": FD_SWEEPS,
                       "fd_eigh": "jacobi"}, True),
        ("tracking_li_bf16", production_overrides() | {"tracking_li_bf16": True}, False),
    ):
        _resume(scene, dev, card, noise, sig, label, overrides, fd)
    _eval_matlab(scene, dev, card, noise, sig)
    _eval_bf16(scene, dev, card, noise, sig)
    _eval_offline(scene, dev, card)


def _kernel_of(key):
    """The wrapper whose kernel a profiler key names: K4 and K7 are
    jacobi_pair_kernel<NP, WARPS, HERM, ONE_BARRIER> up to 64 slots and
    jacobi_eigh_kernel<PER, DOUBLE, HERM, ...> past them; K5 and K11 are
    forms of output_filter_kernel<OVERLAP>."""
    from apvast_torch.ops import kernels as K

    for name in ("jacobi_pair_kernel<", "jacobi_eigh_kernel<"):
        if name in key:  # the third template argument is HERM
            herm = key.split(name, 1)[1].split(",")[2].strip() == "true"
            return "jacobi_eigh_hermitian" if herm else "jacobi_eigh"
    if "output_filter_kernel<false>" in key:
        return "circular_filter"
    return next((name for name in K.WRAPPERS if f"{name}_kernel" in key), None)


def phase4(label, model, x, card, wall_ms_hop):
    """Device time by kernel and by stage over PROFILE_HOPS steady-state hops
    of one path (for the production path one rebuild period), and the
    device's idle share against the unprofiled steady-state hop time. A
    graphed hop runs no torch op on the host, so its kernels are listed by
    name only (the stages need the ops' input shapes)."""
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
            model.process_input_buffers(x[0, i % HOPS], x[1, i % HOPS])
        torch.cuda.synchronize()
    rows = sorted(
        (
            (e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / n / 1e3
    if busy_ms == 0:
        print(f"[phase 4] {label}: idle share not measured (the profiler saw no kernel) "
              f"card={card}", flush=True)
        return
    print(f"[phase 4] {label} path, hops {HOPS + 1}-{HOPS + n} "
          f"({getattr(model, 'rebuilds', 0) - rebuilds} preconditioner rebuilds): kernel time "
          f"{busy_ms:.3f} ms/hop ({sum(r[2] for r in rows) // n} kernels/hop); idle share "
          f"{1 - busy_ms / wall_ms_hop:.3f} of the {wall_ms_hop:.3f} ms/hop "
          f"steady state; card={card}", flush=True)
    if model.graph is not None:
        for name in K.WRAPPERS:
            ms = sum(r[0] for r in rows if _kernel_of(r[1]) == name) / n / 1e3
            if ms:
                print(f"[phase 4] {label} kernel {name} {ms:8.4f} ms/hop", flush=True)
        for dev_us, key, count in rows[:25]:
            print(f"[phase 4] {label}   {dev_us / n / 1e3:8.4f} ms/hop  {count / n:5.1f}/hop  "
                  f"{key[:90]}", flush=True)
        return
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
                         "fd-full path, and of production and invert at 32 speakers")
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

    scene, scene32 = scale_scene(16), scale_scene(SCALE32_SRCS)

    # ---- phase 2: kernels against their plain versions -----------------
    results = phase2(scene, dev, card)
    phase2_folded(scene, dev, card, results)
    phase2_scale32(scene32, dev, card, results)

    # ---- phase 3: the main path ----------------------------------------
    phase3(scene, dev, card, results)
    phase3_fd(scene, dev, card, results)
    phase3_graph(scene, dev, card)
    phase3_serve(scene, dev, card)
    timed = phase3_time(scene, dev, card)
    multi = phase3_multi(scene, dev, card)
    phase3_shard(card)
    scale32 = phase3_scale32(scene32, dev, card, results)
    phase3_demo(card)
    phase3_lag(scene, dev, card)
    phase3_eval(scene, dev, card)

    if args.profile:
        timed |= scale32
        for label, (eager, graphed, x, eager_ms, graphed_ms) in timed.items():
            phase4(f"{label} eager", eager, x, card, eager_ms)
            phase4(f"{label} graphed", graphed, x, card, graphed_ms)
        model, x, ms = multi
        phase4(f"production multi N={MULTI_PROFILE_N} graphed", model, x, card, ms)
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
