"""The per-hop transition (port of ``apvast_tpu/engine/hop.py::process_hop``).

Stage for stage as the JAX engine, with every per-mic / per-src loop of
the reference a batch axis:

1. streaming RIR convolution    (FFT overlap-save, or kernel K1)
2. weighted target update       (WOLA analysis + perceptual weighting)
3. weighted response update     (matmul-DFT or FFT WOLA, or the truncated
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

import torch

from apvast_torch.config import (
    ApVastConfig,
    TargetFilterVariant,
    ToeplitzVariant,
    check_port_slice,
    uses_subspace_solver,
    uses_tracking_solver,
)
from apvast_torch.engine.plan import ApVastPlan
from apvast_torch.engine.state import ApVastState, SubspaceState, TrackingState
from apvast_torch.ops.framing import framed_statistics
from apvast_torch.ops.jdiag import (
    jdiag,
    jdiag_topk_batched,
    jdiag_topk_pencil_batched,
    jdiag_topk_tracked,
)
from apvast_torch.ops.kernels import circular_filter_overlap, covariance, streaming_conv
from apvast_torch.ops.lag_statistics import covariance_via_lags_skew
from apvast_torch.ops.synthesis import variable_span_filters
from apvast_torch.ops.weighting_conv import circular_weighting_conv, weighting_kernel
from apvast_torch.ops.wola import (
    irfft_batched,
    rfft_batched,
    slide,
    slide_tail,
    wola_analyze,
    wola_overlap_add_tail,
    wola_synthesize,
)
from apvast_torch.perceptual.model import perceptual_gain
from apvast_torch.utils.device import torch_dtype

# Path axis: 0=A->A, 1=A->B, 2=B->A, 3=B->B.
_PATH_SIGNAL = [0, 0, 1, 1]  # which program signal drives the path
_PATH_RIR = [0, 1, 0, 1]  # which zone's RIR set the path goes through
_PATH_ZONE = [0, 1, 0, 1]  # destination zone == weighting zone


@dataclasses.dataclass
class HopOutputs:
    """Per-hop loudspeaker feeds, each (V, hop, srcs), None for a disabled
    zone; the target feeds are one (hop, srcs) copy; ``silenced`` counts
    the non-finite solver outputs of the hop (int32 scalar, 0 = healthy);
    ``rebuilt`` says whether the tracking solver refreshed its
    preconditioner, or the 'newton' solver rebuilt its carried inverse,
    this hop (a host bool, False for the other solvers)."""

    out_a: torch.Tensor | None
    out_b: torch.Tensor | None
    out_a_t: torch.Tensor
    out_b_t: torch.Tensor
    silenced: torch.Tensor
    rebuilt: bool = False


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
        path_spec = plan.rir_spec[_PATH_RIR] * seg_spec[_PATH_SIGNAL][:, None, None, :]
        new_resp = irfft_batched(path_spec, nf)[..., nf - hop :]
        tgt_path_spec = plan.target_rir_spec * seg_spec[:, None, :]
        new_target = irfft_batched(tgt_path_spec, nf)[..., nf - hop :]
    return segments[:, hop:], (resp, new_resp), (target_resp, new_target)


def _analyze(config, plan, blocks):
    """WOLA analysis: FFT, or (use_matmul_dft) matmuls against the plan's
    window-folded DFT matrices. ``blocks`` may be a (tail, fresh) pair,
    which the matmul path contracts part by part against row slices of
    the matrices without forming the concatenated block."""
    if isinstance(blocks, tuple):
        if config.use_matmul_dft:
            tail, fresh = blocks
            split = tail.shape[-1]
            re = tail @ plan.dft_cos[:split] + fresh @ plan.dft_cos[split:]
            im = tail @ plan.dft_sin[:split] + fresh @ plan.dft_sin[split:]
            return torch.complex(re, -im)
        blocks = torch.cat(blocks, dim=-1)
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


def _signal_gate(config, dtype, device):
    """Zone run flags gate by signal: paths 0,1 carry A, paths 2,3 B."""
    return torch.tensor(
        [float(config.run_a)] * 2 + [float(config.run_b)] * 2, dtype=dtype, device=device
    )


def weighted_spectra(config, plan, resp, target_resp):
    """Stages 2+3 (spectral part): WOLA analysis of the target and response
    blocks, the perceptual weighting derived from the target spectra, and
    the zone gates. Returns (weighted target spectra, weighted and gated
    response spectra)."""
    t_spec, weighting = target_weighting(config, plan, target_resp)
    r_spec = _analyze(config, plan, resp)  # (4, m, s, bins)
    r_spec = r_spec * _signal_gate(config, weighting.dtype, r_spec.device)[:, None, None, None]
    r_spec = r_spec * weighting[_PATH_ZONE][:, :, None, :]
    return t_spec * weighting, r_spec


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


def rebuild_predicate(config: ApVastConfig, state: ApVastState) -> bool:
    """Whether the tracking solver refreshes its preconditioner this hop:
    inside the warmup window, on the cadence, or when the previous hop's
    Ritz residual exceeds ``tracking_residual_rebuild``. The JAX engine
    decides this on the device under ``lax.cond``; here the hop counter is
    a host int and the residual costs one device read per hop, so the
    factorization runs only on the hops that take it."""
    hop = state.gevd_hop
    if hop < config.tracking_warmup_hops or hop % config.tracking_rebuild_period == 0:
        return True
    threshold = config.tracking_residual_rebuild
    return threshold > 0 and bool(state.gevd_resid > threshold)


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


def hop_statistics(config: ApVastConfig, wresp_stat, wtarget_stat):
    """Stage 4: the spatial statistics (R (4, SJ, SJ), or its half form M
    when :func:`half_form`; r (2, SJ)) of the statistics buffers as a
    state carries them after a hop."""
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
    if config.use_lag_statistics:
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
    if config.normalize_statistics:
        scale = 1.0 / (k * config.num_mics)
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
) -> tuple[ApVastState, HopOutputs]:
    """One hop of ``hop`` samples of each program signal.

    ``rebuild_override``: tracking solver only, a host bool that replaces
    :func:`rebuild_predicate` (a caller driving several streams decides
    the rebuild once for all of them)."""
    check_port_slice(config)
    dtype = torch_dtype(config)
    device = plan.window.device
    hop, block = config.hop, config.block_size
    j, s, v = config.filter_length, config.num_srcs, config.num_eigenvectors
    win = plan.window

    # ---- 1. streaming RIR convolution ----------------------------------
    hops = torch.stack([hop_a, hop_b]).to(device=device, dtype=dtype)  # (2, hop)
    conv_history, resp, target_resp = convolve_inputs(
        config, plan, state.conv_history, state.resp, state.target_resp, hops
    )

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
        new_wr = win * (y * _signal_gate(config, dtype, device)[:, None, None, None])
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

    # ---- 4. statistics -------------------------------------------------
    r_mats, r_vecs = hop_statistics(config, wresp_stat, wtarget_stat)

    # ---- 5. GEVD + variable-span synthesis -----------------------------
    # Zone A pencil: (R_AA, R_AB); zone B pencil: (R_BB, R_BA).
    half = half_form(config)
    a_stack = r_mats[[0, 3]]
    b_stack = r_mats[[1, 2]]
    eye = torch.eye(s * j, dtype=dtype, device=device)
    if config.effective_reg_b_relative > 0:
        # In half form tr(M) = tr(B) / 2 and M takes half of B's loading,
        # so the same expression loads B correctly.
        mean_diag = torch.diagonal(b_stack, dim1=-2, dim2=-1).sum(-1) / (s * j)
        b_stack = b_stack + (config.effective_reg_b_relative * mean_diag)[:, None, None] * eye
    reg = config.reg_b  # PYTHON regularization (check_port_slice)
    # Keep a disabled zone's pencil factorizable (half form: M + M^T = I).
    filler = 0.5 * eye if half else eye
    if not config.run_a:
        a_stack = torch.stack([filler, a_stack[1]])
        b_stack = torch.stack([filler, b_stack[1]])
    if not config.run_b:
        a_stack = torch.stack([a_stack[0], filler])
        b_stack = torch.stack([b_stack[0], filler])
    carry = {}
    rebuilt = False
    whiten = config.subspace_whiten
    _refuse_kernel_flags(config, dtype)
    if not uses_subspace_solver(config):
        u, lam = jdiag(a_stack, b_stack, reg)  # (2, jl, jl), (2, jl)
        # The exact path has no zeroing guard (parity semantics); it counts
        # the non-finite outputs so a blowup stays visible.
        silenced = (
            (~torch.isfinite(u)).sum(dtype=torch.int32)
            + (~torch.isfinite(lam)).sum(dtype=torch.int32)
        )
    elif whiten == "tracking":
        rebuilt = (
            rebuild_predicate(config, state)
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
        )  # u (2, jl, v), lam (2, v)
        carry["gevd_hop"] = state.gevd_hop + 1
    elif whiten == "newton":
        # JAX's lax.cond on the carried inverse's residual is a host
        # decision here: one device read per hop, and only the branch
        # taken runs.
        u, lam, carry["gevd_q"], carry["gevd_minv"], silenced, rebuilt = (
            jdiag_topk_pencil_batched(
                a_stack, b_stack, reg, v, config.subspace_iters,
                state.gevd_q, state.gevd_minv, config.subspace_orth,
                config.small_eigh, config.jacobi_sweeps,
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
    w_family = variable_span_filters(u, lam, r_vecs, config.mu, v)  # (2, v, jl)
    zone_gate = torch.tensor(
        [float(config.run_a), float(config.run_b)], dtype=dtype, device=device
    )
    w_family = w_family * zone_gate[:, None, None]
    if config.output_spans is not None:
        w_family = w_family[:, [sp - 1 for sp in config.output_spans]]
    v = config.num_solutions
    filters = w_family.reshape(2, v, s, j)  # source-major w[s*J + tap]

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
        t_blocks = torch.zeros((2, s, block), dtype=dtype, device=device)
        t_blocks[0, refs[0]] = rolled[0]
        t_blocks[1, refs[1]] = rolled[1]
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
    return new_state, outputs
