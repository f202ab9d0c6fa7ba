"""The frequency-domain engine (port of ``apvast_tpu/engine/fd_hop.py``).

Each STFT bin gets its own S x S (S * B with B cross-frame taps) spatial
covariance pencil, updated by an exponentially-weighted recursion, and
one small Hermitian GEVD per bin and zone replaces the time-domain
engine's JL x JL one. Modes, as in JAX:

- ``fd_span="all"``: every cumulative rank 1..V per bin, through the
  batched Hermitian GEVD (``torch.linalg.eigh``, or kernel K7 under
  ``fd_eigh="jacobi"``);
- ``fd_span="full"``: the full span only, w = (A + mu B_loaded)^-1 r, one
  batched tiny Cholesky solve per bin; optionally solved jointly over
  groups of bins (``fd_group_size``), or refined toward the globally
  leakage-coupled design (``fd_coupled_iters``);
- ``fd_bin_coupling``: statistics smoothed over neighbor bins with the
  J-tap truncation's Dirichlet weights;
- ``fd_frame_taps``: per-bin filters that span B frames.

The designed spectra are constrained to J-tap filters (inverse transform,
truncation, forward transform), and the output synthesis is the
time-domain engine's WOLA. Shared with the time-domain hop: the streaming
RIR convolution (kernel K1 under ``use_pallas_conv``), the perceptual
weighting and the WOLA transforms.

Microphone sharding (``mic_axis``, ``parallel/mesh.py``): each rank
holds a block of the microphones, and each bin's new statistics terms are
summed over the ranks (``ops/collective.py``) before the recursion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apvast_torch.config import ApVastConfig, check_port_slice
from apvast_torch.engine.hop import (
    HopOutputs,
    _analyze,
    _synthesize,
    convolve_inputs,
    weighted_spectra,
)
from apvast_torch.engine.plan import ApVastPlan, hop_gates
from apvast_torch.engine.state import response_tails
from apvast_torch.ops.collective import mic_sum
from apvast_torch.ops.jdiag import eigh, jdiag_hermitian_batched
from apvast_torch.ops.small_chol import cholesky_small, posdef_solve_small
from apvast_torch.ops.wola import (
    irfft_batched,
    rfft_batched,
    slide,
    slide_tail,
    wola_overlap_add_tail,
)
from apvast_torch.utils.device import resolve_device, torch_dtype


@dataclasses.dataclass
class FdState:
    """Carry of the frequency-domain engine: no time-domain statistics
    buffers; the per-bin covariance recursion replaces them."""

    conv_history: torch.Tensor  # (2, fir_history)
    resp: torch.Tensor  # (4, m, s, block - hop), tail form
    target_resp: torch.Tensor  # (2, m, block - hop), tail form
    input_blocks: torch.Tensor  # (2, block)
    out_overlap: torch.Tensor  # (2, V_out, s, block - hop), tail form
    target_out_overlap: torch.Tensor  # (2, s, block - hop), tail form
    # Exponentially-weighted per-bin statistics; with B = fd_frame_taps > 1
    # the per-bin vectors stack the last B frames (tap-major).
    cov: torch.Tensor  # (4, bins, s*B, s*B) complex
    cross: torch.Tensor  # (2, bins, s*B) complex
    # The last B - 1 weighted response and input spectra, most recent first
    # (None when B == 1).
    spec_hist: torch.Tensor | None = None  # (B-1, 4, m, s, bins)
    in_spec_hist: torch.Tensor | None = None  # (B-1, 2, bins)


def fd_state_shapes(config: ApVastConfig) -> dict[str, tuple[int, ...] | None]:
    """Shape of every FD state tensor (None for an absent history)."""
    m, s, v = config.num_mics, config.num_srcs, config.fd_num_solutions
    block, bins, hop = config.block_size, config.num_bins, config.hop
    b = config.fd_frame_taps
    sb = s * b
    return {
        "conv_history": (2, config.fir_history),
        "resp": (4, m, s, block - hop),
        "target_resp": (2, m, block - hop),
        "input_blocks": (2, block),
        "out_overlap": (2, v, s, block - hop),
        "target_out_overlap": (2, s, block - hop),
        "cov": (4, bins, sb, sb),
        "cross": (2, bins, sb),
        "spec_hist": (b - 1, 4, m, s, bins) if b > 1 else None,
        "in_spec_hist": (b - 1, 2, bins) if b > 1 else None,
    }


# The complex-valued FD state fields.
COMPLEX_FIELDS = ("cov", "cross", "spec_hist", "in_spec_hist")


def complex_dtype(config: ApVastConfig) -> torch.dtype:
    return torch.complex64 if config.dtype == "float32" else torch.complex128


def init_fd_state(
    config: ApVastConfig,
    device: str | torch.device | None = None,
    response_noise=None,
    generator: torch.Generator | None = None,
) -> FdState:
    """Fresh FD state on ``device`` (default ``"cuda"``). The initial
    response noise is injected, drawn from ``generator`` or zero, as in
    :func:`apvast_torch.engine.state.init_state`; the rest starts at zero."""
    check_port_slice(config)
    device = resolve_device(device)
    resp, target_resp = response_tails(config, device, response_noise, generator)
    fields = {}
    for name, shape in fd_state_shapes(config).items():
        if name in ("resp", "target_resp") or shape is None:
            continue
        dt = complex_dtype(config) if name in COMPLEX_FIELDS else torch_dtype(config)
        fields[name] = torch.zeros(shape, dtype=dt, device=device)
    return FdState(resp=resp, target_resp=target_resp, **fields)


def _project_spec(config, plan, spec):
    """J-tap truncation projection along the trailing bins axis: inverse
    transform, keep filter_length taps, forward transform. Under
    use_matmul_dft both directions are thin matmuls against the plan's
    (bins, J) / (J, bins) projection matrices. ``spec``: (..., bins)
    complex."""
    if config.use_matmul_dft:
        w_time = spec.real @ plan.proj_idft_cos - spec.imag @ plan.proj_idft_sin
        return torch.complex(w_time @ plan.proj_dft_cos, -(w_time @ plan.proj_dft_sin))
    w_time = irfft_batched(spec, config.block_size)[..., : config.filter_length]
    return rfft_batched(w_time, config.block_size)


def _project_spec_adjoint(config, plan, spec):
    """The transpose of :func:`_project_spec` as a real-linear map of
    (real, imaginary) pairs (the projection is not complex-linear: the
    inverse transform extends the spectrum conjugate-symmetrically), which
    JAX takes with ``jax.linear_transpose``. Matmul form: the transposed
    matrices in reverse order. FFT form, with c_k = 1 at DC and Nyquist
    and 2 elsewhere: c * rfft(truncate(irfft(y / c))), the same map."""
    if config.use_matmul_dft:
        w_bar = spec.real @ plan.proj_dft_cos.T - spec.imag @ plan.proj_dft_sin.T
        return torch.complex(w_bar @ plan.proj_idft_cos.T, -(w_bar @ plan.proj_idft_sin.T))
    c = torch.full((config.num_bins,), 2.0, dtype=spec.real.dtype, device=spec.device)
    c[0] = c[-1] = 1.0
    w_bar = irfft_batched(spec / c, config.block_size)[..., : config.filter_length]
    return c * rfft_batched(w_bar, config.block_size)


def _coupled_refine(config, plan, h, cross, q_raw, reg_vec, w0):
    """Exact-coupling refinement (``fd_coupled_iters``): preconditioned CG,
    or damped Richardson, on the global Tikhonov-regularized normal
    equations (K^adj (A + mu B) K + mu reg I) w = K^adj r, with K the J-tap
    projection applied exactly and the per-bin smoothed and loaded pencils
    ``h`` (2, bins, sb, sb) as the preconditioner. ``cross`` (2, bins, sb)
    is the unsmoothed cross vector, ``q_raw`` (2, bins, sb, sb) the
    unsmoothed A + mu B, ``reg_vec`` (2, bins) the Tikhonov scale, ``w0``
    (2, bins, sb) the per-bin smoothed solution."""
    mu = config.mu

    def apply_k(w):  # K acts per (tap, src) row along bins
        return _project_spec(config, plan, w.transpose(1, 2)).transpose(1, 2)

    def apply_k_adj(y):
        return _project_spec_adjoint(config, plan, y.transpose(1, 2)).transpose(1, 2)

    b = apply_k_adj(cross)
    tik = (mu * reg_vec.to(q_raw.dtype))[:, :, None]

    def apply_c(w):
        qkw = torch.einsum("zfst,zft->zfs", q_raw, apply_k(w))
        return apply_k_adj(qkw) + tik * w

    sb = h.shape[-1]
    chol = cholesky_small(h.reshape(-1, sb, sb))
    chol_h = chol.conj().transpose(-1, -2)

    def precond(r):
        y = torch.linalg.solve_triangular(chol, r.reshape(-1, sb, 1), upper=False)
        return torch.linalg.solve_triangular(chol_h, y, upper=True).reshape(r.shape)

    if config.fd_coupled_method == "cg":
        # Per-zone scalars: the operator and the preconditioner are
        # zone-block-diagonal.
        def zdot(a, c):  # Re<a, c> per zone -> (2, 1, 1)
            return (a.conj() * c).real.sum(dim=(1, 2), keepdim=True)

        tiny = 1e-30
        x = w0
        r = b - apply_c(x)
        z = precond(r)
        p = z
        rz = zdot(r, z)
        for _ in range(config.fd_coupled_iters):
            ap = apply_c(p)
            a_k = rz / torch.clamp_min(zdot(p, ap), tiny)
            x = x + a_k.to(x.dtype) * p
            r = r - a_k.to(r.dtype) * ap
            z = precond(r)
            rz_new = zdot(r, z)
            beta = rz_new / torch.clamp_min(rz, tiny)
            p = z + beta.to(p.dtype) * p
            rz = rz_new
        return x

    w = w0
    for _ in range(config.fd_coupled_iters):
        w = w + config.fd_coupled_relax * precond(b - apply_c(w))
    return w


def _smooth_bins(x, w, hw, nb):
    """``sum_o w[o] x_virtual[f + o]`` along axis 1 (bins), where
    ``x_virtual`` mirrors conjugate-symmetrically about DC and Nyquist (a
    real signal's negative-frequency statistics are the conjugates).
    ``w`` has 2 hw + 1 entries for offsets -hw..hw."""
    xc = x.conj()
    ext = torch.cat(
        [xc[:, 1 : hw + 1].flip(1), x, xc[:, nb - 1 - hw : nb - 1].flip(1)], dim=1
    )
    return sum(complex(w[i]) * ext[:, i : i + nb] for i in range(2 * hw + 1))


def _solve(hg, rhs):
    """``torch.linalg.solve`` that returns NaNs for a singular system, as
    JAX's LU solve does (torch raises instead)."""
    x, info = torch.linalg.solve_ex(hg, rhs)
    return torch.where((info > 0)[..., None, None], torch.nan, x)


def _solve_bin_groups(config, h_diag, q_raw, cross_d, p0, offs, shift):
    """Group-coupled full-span solve (``fd_group_size`` = G > 1): the
    design solved jointly over groups of G adjacent bins, every within-group
    coupling block C_{fg} = sum_o conj(P(o)) P(o + f - g) R_{f+o} / J^2
    kept, as (G S B)^2 Hermitian solves per group and zone. ``h_diag``
    (2, bins, sb, sb) is the loaded smoothed diagonal, ``q_raw`` the
    unsmoothed A + mu B, ``shift`` offsets the partition (the
    ``fd_group_overlap`` pass). Returns w (2, bins, sb)."""
    g = config.fd_group_size
    hw = config.fd_bin_coupling // 2
    nb = config.num_bins
    j = config.filter_length
    sb = h_diag.shape[-1]
    block = config.block_size

    def dirichlet(o):
        return np.exp(-2j * np.pi * np.outer(o, np.arange(j)) / block).sum(axis=1)

    blocks_by_delta = {0: h_diag}
    for d in range(-(g - 1), g):
        if d == 0:
            continue
        w_d = np.conj(p0) * dirichlet(offs + d) / j**2
        blocks_by_delta[d] = _smooth_bins(q_raw, w_d, hw, nb)

    ngroups = -(-(nb + shift) // g)
    nbp = ngroups * g
    back = nbp - nb - shift

    def padfn(x):
        if not (shift or back):
            return x
        pad = torch.zeros((x.shape[0], nbp) + x.shape[2:], dtype=x.dtype, device=x.device)
        pad[:, shift : shift + nb] = x
        return pad

    blocks = {d: padfn(v) for d, v in blocks_by_delta.items()}
    rows = []
    for i in range(g):
        # Group gg, slot i is padded bin gg * g + i -> blocks[d][:, i::g].
        rows.append(torch.stack([blocks[i - jj][:, i::g] for jj in range(g)], dim=3))
    gs = g * sb
    hg = torch.stack(rows, dim=2).reshape(2, ngroups, gs, gs)
    rhs = padfn(cross_d).reshape(2, ngroups, gs, 1)
    if shift or back:
        # Padding slots: zero rows, columns and rhs, 1 on the diagonal, so
        # the padded system stays PD and returns w = 0 there.
        idx = torch.arange(nbp, device=hg.device)
        vm = ((idx >= shift) & (idx < shift + nb)).reshape(ngroups, g)
        vm = vm.repeat_interleave(sb, dim=1).to(hg.real.dtype)
        hg = hg * vm[None, :, :, None] * vm[None, :, None, :]
        eye = torch.eye(gs, dtype=hg.dtype, device=hg.device)
        hg = hg + (1.0 - vm)[None, :, :, None] * eye
        rhs = rhs * vm[None, :, :, None]
    # The offset window's truncation breaks the exact block-Hermitian
    # pairing at the window's tail; symmetrize before the PD solve.
    hg = 0.5 * (hg + hg.conj().transpose(-1, -2))
    hg = hg.reshape(2 * ngroups, gs, gs)
    rhs = rhs.reshape(2 * ngroups, gs, 1)
    tol = config.fd_group_rank_tol
    if tol > 0:
        # Truncated pseudo-inverse over the leakage-significant directions.
        wl, ul = eigh(hg)
        cut = tol * wl[..., -1:]
        inv = torch.where(wl > cut, 1.0 / torch.clamp_min(wl, 1e-30), torch.zeros_like(wl))
        bz = torch.einsum("bji,bjk->bik", ul.conj(), rhs)
        x = torch.einsum("bij,bjk->bik", ul, inv[..., None] * bz)
    else:
        x = _solve(hg, rhs)
    return x.reshape(2, nbp, sb)[:, shift : shift + nb]


def process_hop_fd(
    config: ApVastConfig,
    plan: ApVastPlan,
    state: FdState,
    hop_a: torch.Tensor,
    hop_b: torch.Tensor,
    forgetting: float = 0.9,
    reg: float | None = None,
    mic_axis=None,
) -> tuple[FdState, HopOutputs]:
    """One hop of the frequency-domain engine.

    ``forgetting``: decay of the per-bin covariance recursion. ``reg``:
    diagonal loading per bin; by default ``config.reg_b`` plus 1e-4 of each
    bin's mean dark-covariance trace. ``mic_axis``: a process group over
    which the microphones are sharded (``parallel.mesh``); each bin's new
    statistics terms are all-reduced over it before the recursion, and the
    recursion's state is the same on every rank of the group. Returns the new state and the hop's outputs, whose rank
    axis is ``config.fd_num_solutions``."""
    check_port_slice(config)
    dtype = torch_dtype(config)
    device = plan.window.device
    hop, block = config.hop, config.block_size
    s, v = config.num_srcs, config.num_eigenvectors
    b = config.fd_frame_taps
    sb = s * b
    if v > sb:
        raise ValueError(
            f"frequency-domain span rank is per-bin: num_eigenvectors={v} "
            f"must be <= num_srcs * fd_frame_taps = {sb}"
        )
    if config.fd_span == "full" and v != sb:
        raise ValueError(
            "fd_span='full' is the telescoped full-span solve — it "
            f"requires num_eigenvectors == num_srcs * fd_frame_taps "
            f"({sb}), got {v}"
        )
    if config.output_spans is not None:
        raise ValueError("output_spans is not supported by the FD engine")
    if mic_axis is not None and config.use_pallas_conv:
        raise ValueError(
            "use_pallas_conv is incompatible with mic sharding (the kernel "
            "row stack folds the global mic axis)"
        )

    hops = torch.stack([hop_a, hop_b]).to(device=device, dtype=dtype)
    conv_history, resp, target_resp = convolve_inputs(
        config, plan, state.conv_history, state.resp, state.target_resp, hops
    )
    wt_spec, r_spec = weighted_spectra(config, plan, resp, target_resp)
    # r_spec: (4, m, s, bins); wt_spec: (2, m, bins).

    # ---- per-bin statistics recursion ---------------------------------
    # R_f = lambda R_f + sum_m conj(h_m) h_m^T, r_f = ... conj(h_m) d_m.
    bins = config.num_bins
    if b > 1:
        stacked = torch.cat([r_spec[None], state.spec_hist], dim=0)  # (B, 4, m, s, bins)
        h_vec = stacked.permute(1, 2, 0, 3, 4).reshape(4, -1, sb, bins)
    else:
        h_vec = r_spec
    new_cov = torch.einsum("pmsf,pmtf->pfst", h_vec.conj(), h_vec)
    new_cross = torch.einsum("zmsf,zmf->zfs", h_vec[0::3].contiguous().conj(), wt_spec)
    # Microphone sharding: this rank's terms summed over the mic group.
    new_cov = mic_sum(new_cov, mic_axis)
    new_cross = mic_sum(new_cross, mic_axis)
    cov = forgetting * state.cov + new_cov
    cross = forgetting * state.cross + new_cross

    # ---- leakage-aware bin coupling (fd_bin_coupling = C) -------------
    # The J-tap truncation convolves each designed spectrum with the tap
    # window's Dirichlet kernel P(o); the block-diagonal approximation of
    # the coupled quadratic smooths the statistics with |P(o)|^2 / J^2 and
    # the cross vector with conj(P(o)) / J.
    cov_d, cross_d = cov, cross
    p_o = offs = None
    if config.fd_bin_coupling > 1:
        hw = config.fd_bin_coupling // 2
        if hw >= bins:
            raise ValueError(
                f"fd_bin_coupling={config.fd_bin_coupling} spans more "
                f"than the {bins} available bins"
            )
        j = config.filter_length
        offs = np.arange(-hw, hw + 1)
        p_o = np.exp(-2j * np.pi * np.outer(offs, np.arange(j)) / block).sum(axis=1)
        cov_d = _smooth_bins(cov, np.abs(p_o) ** 2 / j**2, hw, bins)
        cross_d = _smooth_bins(cross, np.conj(p_o) / j, hw, bins)

    # ---- batched per-bin Hermitian GEVD --------------------------------
    # Zone A pencil per bin: (cov[AA], cov[AB]); zone B: (cov[BB], cov[BA]).
    a_stack = cov_d[0::3].reshape(2 * bins, sb, sb)
    b_stack = cov_d[1:3].reshape(2 * bins, sb, sb)
    if reg is None:
        trace = torch.diagonal(b_stack, dim1=-2, dim2=-1).sum(-1).real / sb
        reg_vec = config.reg_b + 1e-4 * trace
    else:
        reg_vec = torch.full((2 * bins,), reg, dtype=dtype, device=device)
    eye = torch.eye(sb, dtype=b_stack.dtype, device=device)
    b_loaded = b_stack + reg_vec[:, None, None] * eye
    mu = config.mu
    v_out = config.fd_num_solutions
    if config.fd_span == "full":
        # w = sum_i (u_i^H r) / (lam_i + mu) u_i = (A + mu B_loaded)^-1 r.
        h = a_stack + mu * b_loaded
        if config.fd_group_size > 1:
            g = config.fd_group_size
            q_raw = cov[0::3] + mu * cov[1:3]
            h_diag = h.reshape(2, bins, sb, sb)
            w = _solve_bin_groups(config, h_diag, q_raw, cross_d, p_o, offs, 0)
            if config.fd_group_overlap:
                # Keep each bin from the pass that places it nearest a
                # group center.
                w1 = _solve_bin_groups(config, h_diag, q_raw, cross_d, p_o, offs, g // 2)
                f = np.arange(bins)
                d0 = np.abs((f % g) - (g - 1) / 2)
                d1 = np.abs(((f + g // 2) % g) - (g - 1) / 2)
                use1 = torch.as_tensor(d1 < d0, device=device)
                w = torch.where(use1[None, :, None], w1, w)
        else:
            w = posdef_solve_small(h, cross_d.reshape(2 * bins, sb, 1))
            if config.fd_coupled_iters > 0:
                q_raw = cov[0::3] + mu * cov[1:3]
                w = _coupled_refine(
                    config, plan, h.reshape(2, bins, sb, sb), cross, q_raw,
                    reg_vec.reshape(2, bins), w.reshape(2, bins, sb),
                )
        w_all = w.reshape(2, bins, 1, sb)  # (2, bins, V_out = 1, sb)
    else:
        if config.fd_eigh == "jacobi" and dtype != torch.float32:
            raise ValueError(
                "fd_eigh='jacobi' is a float32 kernel — it would silently "
                "degrade a float64 config"
            )
        u, lam = jdiag_hermitian_batched(
            a_stack, b_loaded, 0.0, eigh_impl=config.fd_eigh,
            jacobi_sweeps=config.fd_jacobi_sweeps,
        )
        u = u.reshape(2, bins, sb, sb)
        lam = lam.reshape(2, bins, sb)
        # coef_i(f) = (u_i^H r_f) / (lam_i + mu); every rank by a cumsum.
        coef = torch.einsum("zfsi,zfs->zfi", u.conj(), cross_d) / (lam + mu)
        w_all = torch.cumsum(
            coef[..., :v, None] * u.transpose(2, 3)[:, :, :v, :], dim=2
        )  # (2, bins, V, sb)
    w_all = w_all * hop_gates(config, device).zone[:, None, None, None]
    # Silence non-finite bins instead of letting them into the output chain.
    bad_w = ~torch.isfinite(w_all)
    silenced = bad_w.sum(dtype=torch.int32)
    w_all = torch.where(bad_w, torch.zeros_like(w_all), w_all)

    filt_spec = w_all.permute(0, 2, 3, 1).reshape(2, v_out, b, s, bins)
    # Each frame tap constrained to a J-tap FIR filter.
    filt_spec = _project_spec(config, plan, filt_spec)

    # ---- output synthesis (the time-domain engine's WOLA) --------------
    input_blocks = slide(state.input_blocks, hops)
    in_spec = _analyze(config, plan, input_blocks)  # (2, bins)
    if b > 1:
        # Tap tau filters the input spectrum of tau frames ago.
        in_stack = torch.cat([in_spec[None], state.in_spec_hist], dim=0)  # (B, 2, bins)
        out_spec = torch.einsum("zvbsf,bzf->zvsf", filt_spec, in_stack)
    else:
        out_spec = in_spec[:, None, None, :] * filt_spec[:, :, 0]
    new_out = _synthesize(config, plan, out_spec, block)
    out_overlap, out_emit = wola_overlap_add_tail(state.out_overlap, new_out, hop)

    t_out_spec = in_spec[:, None, :] * plan.target_filter_spec
    new_t_out = _synthesize(config, plan, t_out_spec, block)
    target_out_overlap, t_emit = wola_overlap_add_tail(
        state.target_out_overlap, new_t_out, hop
    )

    out_vhs = out_emit.permute(0, 1, 3, 2)  # (2, V_out, hop, s)
    t_vhs = t_emit.permute(0, 2, 1)  # (2, hop, s)
    new_state = FdState(
        conv_history=conv_history,
        resp=slide_tail(resp[0], resp[1], hop),
        target_resp=slide_tail(target_resp[0], target_resp[1], hop),
        input_blocks=input_blocks,
        out_overlap=out_overlap,
        target_out_overlap=target_out_overlap,
        cov=cov,
        cross=cross,
        spec_hist=(torch.cat([r_spec[None], state.spec_hist[:-1]], dim=0)
                   if b > 1 else None),
        in_spec_hist=(torch.cat([in_spec[None], state.in_spec_hist[:-1]], dim=0)
                      if b > 1 else None),
    )
    outputs = HopOutputs(
        out_a=out_vhs[0] if config.run_a else None,
        out_b=out_vhs[1] if config.run_b else None,
        out_a_t=t_vhs[0],
        out_b_t=t_vhs[1],
        silenced=silenced,
    )
    return new_state, outputs
