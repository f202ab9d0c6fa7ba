"""The per-hop transition (port of ``apvast_tpu/engine/hop.py::process_hop``).

Stage for stage as the JAX engine, with every per-mic / per-src loop of
the reference a batch axis:

1. streaming RIR convolution    (FFT overlap-save, or kernel K1)
2. weighted target update       (WOLA analysis + perceptual weighting)
3. weighted response update     (FFT or matmul-DFT WOLA, or the truncated
                                 time-domain weighting: a circular
                                 convolution, kernel K8)
4. statistics                   (framed Gram, plain or kernel K6, or lag
                                 statistics: K2 + K3, half form M with
                                 R = M + M^T for the tracking solver)
5. GEVD + filter synthesis      (exact Cholesky-whitened eigh, the
                                 tracking solver with K4, or the
                                 'invert'/'solve'/'newton' subspace
                                 solvers: K10a, K9, K4)
6. input block slide
7. output synthesis             (FFT, or kernel K5 + the target roll)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apvast_torch.config import (
    ApVastConfig,
    RegularizationVariant,
    TargetFilterVariant,
    ToeplitzVariant,
    check_port_slice,
    uses_subspace_solver,
    uses_tracking_solver,
)
from apvast_torch.engine.plan import ApVastPlan, hop_gates
from apvast_torch.engine.state import ApVastState, SubspaceState, TrackingState
from apvast_torch.observability import meter
from apvast_torch.ops.collective import mic_sum
from apvast_torch.ops.framing import framed_statistics
from apvast_torch.ops.jdiag import (
    jdiag,
    jdiag_topk_batched,
    jdiag_topk_pencil_batched,
    jdiag_topk_tracked,
)
from apvast_torch.ops.kernels import circular_filter_overlap, covariance, streaming_conv
from apvast_torch.ops.lag_statistics import (
    covariance_via_lags,
    covariance_via_lags_skew,
    covariance_via_lags_tap,
    covariance_via_lags_wide,
)
from apvast_torch.ops.synthesis import variable_span_filters
from apvast_torch.ops.weighting_conv import circular_weighting_conv, weighting_kernel
from apvast_torch.ops.wola import (
    irfft_batched,
    rfft_batched,
    slide,
    slide_tail,
    windowed_block,
    wola_analyze,
    wola_overlap_add_tail,
    wola_synthesize,
)
from apvast_torch.perceptual.model import perceptual_gain
from apvast_torch.utils.device import torch_dtype

_meter = meter()

# Path axis: 0=A->A, 1=A->B, 2=B->A, 3=B->B. Program signal A drives paths
# 0 and 1, B paths 2 and 3; path p goes through zone p % 2's RIR set and
# is weighted by zone p % 2 (its destination). A hop indexes by slices and
# concatenations only: an index list would copy an index tensor from the
# host every hop, which a captured hop cannot do.


@dataclasses.dataclass
class HopOutputs:
    """Per-hop loudspeaker feeds, each (V, hop, srcs), None for a disabled
    zone; the target feeds are one (hop, srcs) copy; ``silenced`` counts
    the non-finite solver outputs of the hop (int32 scalar, 0 = healthy);
    ``rebuilt`` says whether the tracking solver refreshed its
    preconditioner, or the 'newton' solver rebuilt its carried inverse,
    this hop (a host bool, False for the other solvers; a bool tensor for
    'newton' deciding on the device, one a scene in the scene-batched
    hop)."""

    out_a: torch.Tensor | None
    out_b: torch.Tensor | None
    out_a_t: torch.Tensor
    out_b_t: torch.Tensor
    silenced: torch.Tensor
    rebuilt: bool | torch.Tensor = False


def _spectral_norm(mat: torch.Tensor) -> torch.Tensor:
    """2-norm of symmetric PSD matrices ``(..., n, n)`` (the MATLAB
    loadings' scale) by 12 steps of power iteration on R^2, normalized
    between the two matvecs so that an unnormalized R(Rv) cannot overflow
    float32 for ||R|| > ~1e9. The Rayleigh quotient lands within ~1% of
    the exact norm on a clustered top spectrum, and a few percent under it
    where a covariance's top eigenvalues form a plateau: enough for a
    loading constant. Fixed steps and no host read, so a captured hop can
    run it."""
    v = torch.ones(mat.shape[:-1], dtype=mat.dtype, device=mat.device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def matvec(x):
        return (mat @ x[..., None])[..., 0]

    for _ in range(12):
        w = matvec(v)
        w = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-30)
        w = matvec(w)
        v = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-30)
    return (v * matvec(v)).sum(-1).abs()


def loaded_pencils(config: ApVastConfig, a_stack, b_stack, eye):
    """Stage 5's diagonal loading of the zones' pencils: the scale-relative
    dark loading, then the configured regularization. Returns (A, B, reg),
    ``reg`` the fixed loading the solver adds to B (``reg_b`` for PYTHON,
    0 for the norm-scaled loadings, which are added here)."""
    if config.effective_reg_b_relative > 0:
        # In half form tr(M) = tr(B) / 2 and M takes half of B's loading,
        # so the same expression loads B correctly.
        n = b_stack.shape[-1]
        mean_diag = torch.diagonal(b_stack, dim1=-2, dim2=-1).sum(-1) / n
        b_stack = b_stack + (config.effective_reg_b_relative * mean_diag)[:, None, None] * eye
    if config.regularization is RegularizationVariant.PYTHON:
        return a_stack, b_stack, config.reg_b
    if config.regularization is RegularizationVariant.PYTHON_NORM:
        b_stack = b_stack + 1e-8 * _spectral_norm(b_stack)[:, None, None] * eye
        return a_stack, b_stack, 0.0
    # MATLAB: both matrices, each by its own fraction of its norm.
    a_norms, b_norms = _spectral_norm(a_stack), _spectral_norm(b_stack)
    a_stack = a_stack + config.bright_loading * a_norms[:, None, None] * eye
    b_stack = b_stack + config.dark_loading * b_norms[:, None, None] * eye
    return a_stack, b_stack, 0.0


def convolve_inputs(config, plan, conv_history, resp, target_resp, hops):
    """Stage 1: streaming RIR convolution. Returns the new history and the
    (tail, fresh-hop) pairs of the response and target blocks."""
    hop = config.hop
    nf = config.fir_fft_size
    m, s = resp.shape[1], resp.shape[2]
    segments = torch.cat([conv_history, hops], dim=-1)  # (2, nf)
    if config.use_pallas_conv:
        out = streaming_conv(segments, plan.conv_kernels, hop)  # (2, 2ms+m, hop)
        ms = m * s
        # Row layout per signal: [rir_A (m*s), rir_B (m*s), target_z (m)].
        new_resp = torch.stack(
            [out[0, :ms], out[0, ms : 2 * ms], out[1, :ms], out[1, ms : 2 * ms]]
        ).reshape(4, m, s, hop)
        new_target = out[:, 2 * ms :, :]  # (2, m, hop)
    else:
        seg_spec = torch.fft.rfft(segments, dim=-1)  # (2, nf/2+1)
        # Rows by path: the RIR sets [A, B, A, B], the signals [A, A, B, B].
        path_rir = torch.cat([plan.rir_spec, plan.rir_spec])
        path_signal = seg_spec[:, None].expand(2, 2, seg_spec.shape[-1]).reshape(4, -1)
        path_spec = path_rir * path_signal[:, None, None, :]
        new_resp = irfft_batched(path_spec, nf)[..., nf - hop :]
        tgt_path_spec = plan.target_rir_spec * seg_spec[:, None, :]
        new_target = irfft_batched(tgt_path_spec, nf)[..., nf - hop :]
    return segments[:, hop:], (resp, new_resp), (target_resp, new_target)


def _analyze(config, plan, blocks):
    """WOLA analysis: ``rfft`` (cuFFT on the card) of the windowed blocks,
    or (use_matmul_dft) matmuls against the plan's window-folded DFT
    matrices. ``blocks`` may be a (tail, fresh) pair: the matmul path
    contracts it part by part against row slices of the matrices, the FFT
    path writes the windowed parts straight into the one block that
    ``rfft`` reads."""
    if isinstance(blocks, tuple):
        tail, fresh = blocks
        if config.use_matmul_dft:
            split = tail.shape[-1]
            re = tail @ plan.dft_cos[:split] + fresh @ plan.dft_cos[split:]
            im = tail @ plan.dft_sin[:split] + fresh @ plan.dft_sin[split:]
            return torch.complex(re, -im)
        return rfft_batched(windowed_block(plan.window, tail, fresh), config.block_size)
    if config.use_matmul_dft:
        return torch.complex(blocks @ plan.dft_cos, -(blocks @ plan.dft_sin))
    return wola_analyze(plan.window, blocks)


def _synthesize(config, plan, spectra, block):
    """WOLA synthesis: inverse FFT, or inverse-DFT matmuls (synthesis
    window folded into the matrices)."""
    if config.use_matmul_dft:
        return spectra.real @ plan.idft_cos - spectra.imag @ plan.idft_sin
    return wola_synthesize(plan.window, spectra, block)


def target_weighting(config, plan, target_resp):
    """WOLA analysis of the target blocks and the perceptual weighting
    derived from them. Returns (target spectra (2, m, bins) complex,
    weighting (2, m, bins) real)."""
    t_spec = _analyze(config, plan, target_resp)
    if config.perceptual:
        weighting = perceptual_gain(
            t_spec, plan.cfmr_sq, plan.cs, plan.ca, plan.leff,
            plan.spectrum_scale, config.weighting_norm,
        )
    else:
        weighting = torch.ones(
            t_spec.shape, dtype=torch_dtype(config), device=t_spec.device
        )
    return t_spec, weighting


def weighted_spectra(config, plan, resp, target_resp):
    """Stages 2+3 (spectral part): WOLA analysis of the target and response
    blocks, the perceptual weighting derived from the target spectra, and
    the zone gates. Returns (weighted target spectra, weighted and gated
    response spectra)."""
    t_spec, weighting = target_weighting(config, plan, target_resp)
    r_spec = _analyze(config, plan, resp)  # (4, m, s, bins)
    # The zone gates (0 or 1) and the weighting as one real factor: one
    # pass over the response spectra.
    gates = hop_gates(config, r_spec.device)
    gain = torch.cat([weighting, weighting]) * gates.signal[:, None, None]
    return t_spec * weighting, r_spec * gain[:, :, None, :]


def half_form(config: ApVastConfig) -> bool:
    """Whether stage 4 hands the solver the half matrices M (R = M + M^T):
    the skew lag statistics feeding the tracking solver. Any other solver
    gets the completed R, as in the JAX engine."""
    return (
        config.statistics_half_form
        and config.use_lag_statistics
        and config.lag_assembly == "skew"
        and uses_tracking_solver(config)
    )


def rebuild_predicate(config: ApVastConfig, gevd_hop: int, read_resid) -> bool:
    """Whether the tracking solver refreshes its preconditioner on hop
    ``gevd_hop``: inside the warmup window, on the cadence, or when the
    previous hop's Ritz residual exceeds ``tracking_residual_rebuild``. The
    JAX engine decides this on the device under ``lax.cond``; here the hop
    counter is a host int and ``read_resid()`` gives the residual (float32)
    from the device, called only on the hops that need it, so the
    factorization runs only on the hops that take it and the hop body
    takes the decision as an argument. Each decision is counted by its
    cause in the hop meter (``observability.HopMeter.decided``)."""
    if gevd_hop < config.tracking_warmup_hops:
        return _meter.decided("warmup")
    if gevd_hop % config.tracking_rebuild_period == 0:
        return _meter.decided("cadence")
    threshold = config.tracking_residual_rebuild
    # In float32, as the tensor comparison with a Python threshold is.
    if threshold > 0 and bool(np.float32(read_resid()) > np.float32(threshold)):
        return _meter.decided("residual")
    return _meter.decided("none")


_JACOBI_F64 = (
    "small_eigh='jacobi' is a float32 kernel — it would "
    "silently degrade a float64 parity config"
)


def _refuse_kernel_flags(config: ApVastConfig, dtype: torch.dtype) -> None:
    """Stage 5's refusals of the JAX engine, in its order and wording per
    whitening: a float32 kernel flag on a float64 config, or a kernel flag
    under a whitening that does not run its kernel."""
    if not uses_subspace_solver(config):
        return
    f64 = dtype != torch.float32
    jacobi = config.small_eigh == "jacobi"
    subspace, whiten = config.use_pallas_subspace, config.use_pallas_whiten
    checks = {
        "tracking": [
            (f64 and jacobi, _JACOBI_F64),
            (subspace or whiten, "use_pallas_subspace/use_pallas_whiten require "
             "subspace_whiten='invert'"),
        ],
        "newton": [
            (subspace, "use_pallas_subspace requires subspace_whiten='invert'"),
            (f64 and jacobi, _JACOBI_F64),
        ],
    }.get(config.subspace_whiten, [
        (f64 and (jacobi or subspace), "small_eigh='jacobi' and use_pallas_subspace are "
         "float32 kernels — they would silently degrade a float64 parity config to "
         "float32 precision"),
        (f64 and whiten, "use_pallas_whiten is a float32 kernel — it would silently "
         "degrade a float64 parity config"),
    ])
    for refused, message in checks:
        if refused:
            raise ValueError(message)


def tap_major(config: ApVastConfig) -> bool:
    """Whether stage 4 lays the statistics out tap-major (the "tap"
    assembly): rows (tap, source), so the filters come out (J, S)."""
    return config.use_lag_statistics and config.lag_assembly == "tap"


_LAG_ASSEMBLIES = {
    "pair": covariance_via_lags,
    "tap": covariance_via_lags_tap,
    "wide": covariance_via_lags_wide,
}


def hop_statistics(config: ApVastConfig, wresp_stat, wtarget_stat, mic_axis=None):
    """Stage 4: the spatial statistics (R (4, SJ, SJ), or its half form M
    when :func:`half_form`; r (2, SJ); tap-major for :func:`tap_major`) of
    the statistics buffers as a state carries them after a hop.
    ``mic_axis``: the process group over which the buffers' microphones
    are sharded; the partial sums are all-reduced over it before the
    normalization, which divides by the global microphone count."""
    j = config.filter_length
    if (
        config.toeplitz_variant is ToeplitzVariant.PYTHON
        and not config.carried_deleted_statistics
    ):
        buf_eff = torch.cat([wresp_stat[..., :j], wresp_stat[..., j + 1 :]], dim=-1)
    else:
        buf_eff = wresp_stat
    k = buf_eff.shape[-1] - j + 1
    d = wtarget_stat[..., -k:]  # (2, m, k) target alignment
    # The JAX engine also takes the dense kernel path when the skew kernel
    # cannot lower (S % 8 != 0 off the CPU, a Mosaic limit). The port's K3
    # serves any S, as the JAX package does on the CPU it is held against,
    # so the lag statistics never fall back here.
    if config.use_lag_statistics and config.lag_assembly != "skew":
        r_mats, r_vecs = _LAG_ASSEMBLIES[config.lag_assembly](buf_eff, d, j)
    elif config.use_lag_statistics:
        form = "half" if half_form(config) else "full"
        r_mats, r_vecs = covariance_via_lags_skew(buf_eff, d, j, form=form)
    elif config.use_pallas_statistics:
        if config.dtype != "float32":
            raise ValueError("use_pallas_statistics requires dtype=float32")
        r_mats, r_cross = covariance(buf_eff.contiguous(), d.contiguous(), j)
        # Bright paths against their own zone's target.
        r_vecs = torch.stack([r_cross[0, :, 0], r_cross[3, :, 1]])
    else:
        r_mats, r_vecs = framed_statistics(buf_eff, d, j)
    r_mats = mic_sum(r_mats, mic_axis)
    r_vecs = mic_sum(r_vecs, mic_axis)
    if config.normalize_statistics:
        scale = 1.0 / (k * config.num_mics)  # the global microphone count
        r_mats = r_mats * scale
        r_vecs = r_vecs * scale
    return r_mats, r_vecs


def process_hop(
    config: ApVastConfig,
    plan: ApVastPlan,
    state: ApVastState,
    hop_a: torch.Tensor,
    hop_b: torch.Tensor,
    rebuild_override: bool | None = None,
    mic_axis=None,
    select_rebuild: bool = False,
) -> tuple[ApVastState, HopOutputs]:
    """One hop of ``hop`` samples of each program signal.

    ``rebuild_override``: tracking solver only, a host bool that replaces
    :func:`rebuild_predicate` (a caller driving several streams decides
    the rebuild once for all of them). ``mic_axis``: a process group over
    which the microphones are sharded (``parallel.mesh``): this rank's
    state and plan hold its microphone block, and the partial statistics
    are all-reduced over the group, the hop's one collective; None runs
    every microphone here. ``select_rebuild``: 'newton' only, decide the
    rebuild on the device by a select of both branches (the scene-batched
    hop's form, under ``torch.func.vmap``); ``rebuilt`` is then a bool
    tensor.

    The section boundaries are the hop meter's timed marks
    (``observability.MARKS``, ``HopMeter.mark``), recorded only into a
    graph being captured."""
    check_port_slice(config)
    if mic_axis is not None and config.use_pallas_conv:
        raise ValueError(
            "use_pallas_conv is incompatible with mic sharding (the kernel "
            "row stack folds the global mic axis)"
        )
    if half_form(config) and config.regularization is not RegularizationVariant.PYTHON:
        raise ValueError(
            "statistics_half_form supports PYTHON regularization only "
            "(norm-based loading needs the completed matrix)"
        )
    dtype = torch_dtype(config)
    device = plan.window.device
    hop, block = config.hop, config.block_size
    j, s, v = config.filter_length, config.num_srcs, config.num_eigenvectors
    win = plan.window
    _meter.mark("start")

    # ---- 1. streaming RIR convolution ----------------------------------
    hops = torch.stack([hop_a, hop_b]).to(device=device, dtype=dtype)  # (2, hop)
    conv_history, resp, target_resp = convolve_inputs(
        config, plan, state.conv_history, state.resp, state.target_resp, hops
    )
    _meter.mark("conv")

    # ---- 2+3. perceptual weighting of target and responses -------------
    taps = config.weighting_conv_taps
    if taps is not None:
        # Truncated time-domain weighting: the target path stays exact (2M
        # rows, it feeds r); the 4MS response rows take a circular
        # convolution with the T-tap centre of each weighting's impulse
        # response (kernel K8 for float32 on the card).
        t_spec, weighting = target_weighting(config, plan, target_resp)
        wt_spec = t_spec * weighting
        kernels = weighting_kernel(weighting, block, taps, plan.idft_cos_plain)  # (2, m, T)
        y = circular_weighting_conv(win * torch.cat(resp, dim=-1), kernels, taps)
        new_wr = win * (y * hop_gates(config, device).signal[:, None, None, None])
    else:
        wt_spec, r_spec = weighted_spectra(config, plan, resp, target_resp)
        new_wr = _synthesize(config, plan, r_spec, block)
    new_wt = _synthesize(config, plan, wt_spec, block)
    wtarget_overlap, wt_emit = wola_overlap_add_tail(state.wtarget_overlap, new_wt, hop)
    wtarget_stat = slide(state.wtarget_stat, wt_emit)
    wresp_overlap, wr_emit = wola_overlap_add_tail(state.wresp_overlap, new_wr, hop)
    if config.carried_deleted_statistics:
        # The state carries the sample-J-deleted buffer: slide and deletion
        # collapse into one concatenation (raw[t] = deleted[t-1], t > J).
        prev = state.wresp_stat
        wresp_stat = torch.cat(
            [prev[..., hop - 1 : hop - 1 + j], prev[..., hop + j :], wr_emit], dim=-1
        )
    else:
        wresp_stat = slide(state.wresp_stat, wr_emit)
    _meter.mark("weight")

    # ---- 4. statistics -------------------------------------------------
    r_mats, r_vecs = hop_statistics(config, wresp_stat, wtarget_stat, mic_axis)
    _meter.mark("stats")

    # ---- 5. GEVD + variable-span synthesis -----------------------------
    # Zone A pencil: (R_AA, R_AB); zone B pencil: (R_BB, R_BA).
    half = half_form(config)
    eye = torch.eye(s * j, dtype=dtype, device=device)
    a_stack, b_stack, reg = loaded_pencils(
        config, r_mats[0::3].contiguous(), r_mats[1:3].contiguous(), eye
    )
    # Keep a disabled zone's pencil factorizable (half form: M + M^T = I).
    filler = 0.5 * eye if half else eye
    if not config.run_a:
        a_stack = torch.stack([filler, a_stack[1]])
        b_stack = torch.stack([filler, b_stack[1]])
    if not config.run_b:
        a_stack = torch.stack([a_stack[0], filler])
        b_stack = torch.stack([b_stack[0], filler])
    _meter.mark("pencils")
    carry = {}
    rebuilt = False
    whiten = config.subspace_whiten
    _refuse_kernel_flags(config, dtype)
    tracking = uses_subspace_solver(config) and whiten == "tracking"
    if not tracking:
        # The tracking solver marks its rebuild factorization itself; the
        # other solvers' factorizations count as their step.
        _meter.mark("factor")
    if not uses_subspace_solver(config):
        u, lam = jdiag(a_stack, b_stack, reg)  # (2, jl, jl), (2, jl)
        # The exact path has no zeroing guard (parity semantics); it counts
        # the non-finite outputs so a blowup stays visible.
        silenced = (
            (~torch.isfinite(u)).sum(dtype=torch.int32)
            + (~torch.isfinite(lam)).sum(dtype=torch.int32)
        )
    elif tracking:
        rebuilt = (
            rebuild_predicate(config, state.gevd_hop, lambda: state.gevd_resid.item())
            if rebuild_override is None
            else bool(rebuild_override)
        )
        (
            u, lam, carry["gevd_q"], carry["gevd_lam"], carry["gevd_minv"],
            silenced, carry["gevd_resid"],
        ) = jdiag_topk_tracked(
            a_stack, b_stack, reg, v,
            state.gevd_q, state.gevd_lam, state.gevd_minv, rebuilt,
            outer_steps=config.tracking_outer_steps,
            small_eigh=config.small_eigh,
            jacobi_sweeps=config.jacobi_sweeps,
            rr_basis=config.tracking_rr_basis,
            half_form=half,
            residual_precision=config.tracking_residual_precision,
        )  # u (2, jl, v), lam (2, v)
        carry["gevd_hop"] = state.gevd_hop + 1
    elif whiten == "newton":
        # JAX's lax.cond on the carried inverse's residual is a host
        # decision here (one device read per hop, only the branch taken
        # runs), or with select_rebuild a select of both branches.
        u, lam, carry["gevd_q"], carry["gevd_minv"], silenced, rebuilt = (
            jdiag_topk_pencil_batched(
                a_stack, b_stack, reg, v, config.subspace_iters,
                state.gevd_q, state.gevd_minv, config.subspace_orth,
                config.small_eigh, config.jacobi_sweeps, select=select_rebuild,
            )
        )
    else:
        # The JAX engine's rule for the whitening kernel (its VMEM bound):
        # 'invert' and a 128-padded jl of at most 1024.
        whiten_kernel = (
            config.use_pallas_whiten
            and whiten == "invert"
            and -(-config.jl // 128) * 128 <= 1024
        )
        u, lam, carry["gevd_q"], silenced = jdiag_topk_batched(
            a_stack, b_stack, reg, v, config.subspace_iters, state.gevd_q,
            config.subspace_orth, whiten, config.small_eigh,
            config.jacobi_sweeps,
            fused_iteration=config.use_pallas_subspace,
            whiten_kernel=whiten_kernel,
        )  # (2, jl, v), (2, v), (2, jl, k), int32
        carry["gevd_minv"] = None
    _meter.mark("track")
    w_family = variable_span_filters(u, lam, r_vecs, config.mu, v)  # (2, v, jl)
    gates = hop_gates(config, device)
    w_family = w_family * gates.zone[:, None, None]
    if gates.spans is not None:
        w_family = w_family[:, gates.spans]
    v = config.num_solutions
    if tap_major(config):
        # Tap-major statistics give tap-major eigenvectors: w[tap*S + s].
        filters = w_family.reshape(2, v, j, s).transpose(-1, -2)
    else:
        filters = w_family.reshape(2, v, s, j)  # source-major w[s*J + tap]
    _meter.mark("solve")

    # ---- 6. slide input blocks -----------------------------------------
    input_blocks = slide(state.input_blocks, hops)

    # ---- 7. output synthesis -------------------------------------------
    if config.use_pallas_output:
        # A J-tap filter's spectral product is a circular convolution:
        # kernel K5, with the synthesis window and the overlap-add fused.
        win_in = (win * input_blocks).contiguous()  # (2, block)
        bh = block - hop
        emit_f, tail_f = circular_filter_overlap(
            win_in,
            filters.reshape(2, v * s, j).contiguous(),
            win,
            state.out_overlap.reshape(2, v * s, bh).contiguous(),
            hop,
        )
        out_emit = emit_f.reshape(2, v, s, hop)
        out_overlap = tail_f.reshape(2, v, s, bh)
        # The target filter is a delta at (reference index, modeling
        # delay): its circular convolution is a roll.
        rolled = torch.roll(win_in, config.modeling_delay, dims=-1)
        if config.target_filter is TargetFilterVariant.SHARED_A:
            refs = (config.reference_index_a, config.reference_index_a)
        else:
            refs = (config.reference_index_a, config.reference_index_b)
        # Zone z's target block: the rolled input in row refs[z], zeros
        # elsewhere (padded, not written in place, so that vmap passes).
        t_blocks = torch.stack([
            torch.nn.functional.pad(rolled[z, None], (0, 0, ref, s - 1 - ref))
            for z, ref in enumerate(refs)
        ])
        new_t_out = win * t_blocks
    else:
        filt_spec = rfft_batched(filters, block)  # (2, v, s, bins)
        in_spec = _analyze(config, plan, input_blocks)  # (2, bins)
        new_out = _synthesize(config, plan, in_spec[:, None, None, :] * filt_spec, block)
        new_t_out = _synthesize(
            config, plan, in_spec[:, None, :] * plan.target_filter_spec, block
        )
        out_overlap, out_emit = wola_overlap_add_tail(state.out_overlap, new_out, hop)
    target_out_overlap, t_emit = wola_overlap_add_tail(
        state.target_out_overlap, new_t_out, hop
    )

    out_vhs = out_emit.permute(0, 1, 3, 2)  # (2, v, hop, s)
    t_vhs = t_emit.permute(0, 2, 1)  # (2, hop, s)
    if not carry:
        state_cls = ApVastState
    else:
        state_cls = TrackingState if "gevd_lam" in carry else SubspaceState
    new_state = state_cls(
        conv_history=conv_history,
        resp=slide_tail(resp[0], resp[1], hop),
        target_resp=slide_tail(target_resp[0], target_resp[1], hop),
        wresp_overlap=wresp_overlap,
        wtarget_overlap=wtarget_overlap,
        wresp_stat=wresp_stat,
        wtarget_stat=wtarget_stat,
        input_blocks=input_blocks,
        out_overlap=out_overlap,
        target_out_overlap=target_out_overlap,
        **carry,
    )
    outputs = HopOutputs(
        out_a=out_vhs[0] if config.run_a else None,
        out_b=out_vhs[1] if config.run_b else None,
        out_a_t=t_vhs[0],
        out_b_t=t_vhs[1],
        silenced=silenced,
        rebuilt=rebuilt,
    )
    _meter.mark("out")
    return new_state, outputs
