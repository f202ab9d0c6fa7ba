"""Precomputed constants of the AP-VAST engine (port of
``apvast_tpu/engine/plan.py``): the WOLA window, the RIR and target
spectra of the streaming convolution, the raw kernel rows of K1, the delta
target playback filters, the matmul-DFT matrices with the windows folded
in (and the unwindowed inverse that the truncated weighting uses), the
frequency-domain engine's J-tap projection matrices, and the calibrated
perceptual tables. All tensors live on one device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from apvast_torch.config import (
    ApVastConfig,
    PerceptualFrontend,
    TargetFilterVariant,
    check_port_slice,
)
from apvast_torch.ops.wola import sine_window
from apvast_torch.perceptual.tables import (
    build_libdetectability_tables,
    build_perceptual_tables,
)
from apvast_torch.utils.device import resolve_device, torch_dtype


@dataclasses.dataclass
class ApVastPlan:
    """Device constants. Shapes as in the JAX ``ApVastPlan``."""

    window: torch.Tensor  # (block,)
    rir_spec: torch.Tensor  # (2, m, s, nf/2+1) complex, by destination zone
    target_rir_spec: torch.Tensor  # (2, m, nf/2+1) complex
    target_filter_spec: torch.Tensor  # (2, s, bins) complex
    conv_kernels: torch.Tensor  # (2, 2ms+m, rir_length): [rir_A, rir_B, target_z]
    dft_cos: torch.Tensor | None  # (block, bins), analysis window folded in
    dft_sin: torch.Tensor | None
    idft_cos: torch.Tensor | None  # (bins, block), synthesis window folded in
    idft_sin: torch.Tensor | None
    # The inverse DFT without the window, (bins, block): the truncated
    # weighting's impulse responses (ops/weighting_conv.weighting_kernel).
    idft_cos_plain: torch.Tensor | None
    # The FD engine's J-tap truncation projection (use_matmul_dft): the
    # first J samples of the inverse transform, (bins, J), and the forward
    # transform of J samples, (J, bins); no windows.
    proj_idft_cos: torch.Tensor | None
    proj_idft_sin: torch.Tensor | None
    proj_dft_cos: torch.Tensor | None
    proj_dft_sin: torch.Tensor | None
    # Perceptual tables (None when config.perceptual is False); the four
    # scalars are 0-dim tensors of the config's dtype.
    cfmr_sq: torch.Tensor | None  # (bins, channels)
    cs: torch.Tensor | None
    ca: torch.Tensor | None
    leff: torch.Tensor | None
    spectrum_scale: torch.Tensor | None


@dataclasses.dataclass(frozen=True)
class HopGates:
    """The zone run flags as device tensors, which every hop multiplies in:
    ``signal`` (4,) by path (paths 0 and 1 carry program A, 2 and 3 B),
    ``zone`` (2,) by zone; and ``spans`` (the 0-based ranks of
    ``config.output_spans``, int64) or None."""

    signal: torch.Tensor
    zone: torch.Tensor
    spans: torch.Tensor | None


def hop_gates(config: ApVastConfig, device: torch.device) -> HopGates:
    """:class:`HopGates` of ``config`` on ``device``, built on the first
    call and then reused, so that no hop copies them from the host (a
    captured hop cannot). They live beside the plan, whose fields are the
    JAX plan's."""
    return _hop_gates(config.run_a, config.run_b, config.output_spans,
                      torch_dtype(config), torch.device(device))


@functools.lru_cache(maxsize=None)
def _hop_gates(run_a, run_b, output_spans, dtype, device) -> HopGates:
    flags = [float(run_a), float(run_b)]
    spans = None
    if output_spans is not None:
        spans = torch.tensor([sp - 1 for sp in output_spans], device=device)
    return HopGates(
        signal=torch.tensor(flags[:1] * 2 + flags[1:] * 2, dtype=dtype, device=device),
        zone=torch.tensor(flags, dtype=dtype, device=device),
        spans=spans,
    )


def _delayed_target_rir(rir: np.ndarray, ref_index: int, delay: int) -> np.ndarray:
    """(rir_length, num_mics): the reference speaker's response delayed by
    the modeling delay."""
    ref = rir[:, ref_index, :]
    out = np.zeros_like(ref)
    out[delay:, :] = ref[: ref.shape[0] - delay, :]
    return out


def build_plan(
    config: ApVastConfig,
    rir_a: np.ndarray,
    rir_b: np.ndarray,
    device: str | torch.device | None = None,
) -> ApVastPlan:
    """Precompute the engine constants of one scene on ``device`` (default
    ``"cuda"``; raises if no card is present unless ``device="cpu"``).
    ``rir_a`` / ``rir_b`` are laid out ``(rir_length, num_srcs, num_mics)``.
    """
    check_port_slice(config)
    device = resolve_device(device)
    expected = (config.rir_length, config.num_srcs, config.num_mics)
    if rir_a.shape != expected or rir_b.shape != expected:
        raise ValueError(
            f"RIR shape {rir_a.shape}/{rir_b.shape} does not match config {expected}"
        )
    np_dtype = np.dtype(config.dtype)
    dtype = torch_dtype(config)
    rir_a = np.asarray(rir_a, dtype=np_dtype)
    rir_b = np.asarray(rir_b, dtype=np_dtype)
    nf = config.fir_fft_size

    def dev(x):
        return torch.as_tensor(np.array(x, order="C"), device=device)

    kernels = np.stack([rir_a.transpose(2, 1, 0), rir_b.transpose(2, 1, 0)])  # (2, m, s, taps)
    tgt_a = _delayed_target_rir(rir_a, config.reference_index_a, config.modeling_delay)
    tgt_b = _delayed_target_rir(rir_b, config.reference_index_b, config.modeling_delay)
    target_kernels = np.stack([tgt_a.T, tgt_b.T])  # (2, m, taps)

    def delta_filter(ref_index: int) -> np.ndarray:
        f = np.zeros((config.num_srcs, config.filter_length), dtype=np_dtype)
        f[ref_index, config.modeling_delay] = 1.0
        return f

    if config.target_filter is TargetFilterVariant.SHARED_A:
        shared = delta_filter(config.reference_index_a)
        target_filters = np.stack([shared, shared])
    else:
        target_filters = np.stack(
            [
                delta_filter(config.reference_index_a),
                delta_filter(config.reference_index_b),
            ]
        )

    cfmr_sq = cs = ca = leff = spectrum_scale = None
    if config.perceptual:
        if config.perceptual_frontend is PerceptualFrontend.LIBDETECTABILITY:
            tables = build_libdetectability_tables(
                config.block_size, float(config.sampling_rate), config.perceptual_taps
            )
        else:
            tables = build_perceptual_tables(
                config.block_size,
                float(config.sampling_rate),
                config.pressure_scale_db_spl,
                config.threshold_method,
            )
        cfmr_sq, cs, ca, leff, spectrum_scale = (
            dev(np.asarray(x, dtype=np_dtype))
            for x in (
                tables.cfmr_sq, tables.cs, tables.ca, tables.leff,
                tables.spectrum_scale,
            )
        )

    rir_rows = kernels.reshape(2, -1, config.rir_length)  # (2=AB, m*s, taps)
    conv_kernels = np.stack(
        [
            np.concatenate([rir_rows[0], rir_rows[1], target_kernels[0]]),
            np.concatenate([rir_rows[0], rir_rows[1], target_kernels[1]]),
        ]
    )

    window = sine_window(config.block_size, dtype=dtype, device=device)
    dft_cos = dft_sin = idft_cos = idft_sin = idft_cos_plain = None
    proj_idft_cos = proj_idft_sin = proj_dft_cos = proj_dft_sin = None
    if config.use_matmul_dft:
        block = config.block_size
        ang = (
            2.0 * np.pi * np.outer(np.arange(block), np.arange(block // 2 + 1)) / block
        )
        inv_w = np.full(block // 2 + 1, 2.0 / block)
        inv_w[0] = 1.0 / block
        inv_w[-1] = 1.0 / block
        # (win*x) @ C == x @ (win[:, None]*C): the windows fold into the
        # matrices, so the hop spends no elementwise window pass.
        win = window.cpu().numpy()
        dft_cos = dev((win[:, None] * np.cos(ang)).astype(np_dtype))
        dft_sin = dev((win[:, None] * np.sin(ang)).astype(np_dtype))
        idft_cos = dev(((np.cos(ang) * inv_w).T * win[None, :]).astype(np_dtype))
        idft_sin = dev(((np.sin(ang) * inv_w).T * win[None, :]).astype(np_dtype))
        idft_cos_plain = dev((np.cos(ang) * inv_w).T.astype(np_dtype))
        j = config.filter_length
        proj_idft_cos = dev((np.cos(ang[:j]) * inv_w).T.astype(np_dtype))
        proj_idft_sin = dev((np.sin(ang[:j]) * inv_w).T.astype(np_dtype))
        proj_dft_cos = dev(np.cos(ang[:j]).astype(np_dtype))
        proj_dft_sin = dev(np.sin(ang[:j]).astype(np_dtype))

    return ApVastPlan(
        window=window,
        rir_spec=torch.fft.rfft(dev(kernels), n=nf, dim=-1),
        target_rir_spec=torch.fft.rfft(dev(target_kernels), n=nf, dim=-1),
        target_filter_spec=torch.fft.rfft(
            dev(target_filters), n=config.block_size, dim=-1
        ),
        conv_kernels=dev(conv_kernels),
        dft_cos=dft_cos,
        dft_sin=dft_sin,
        idft_cos=idft_cos,
        idft_sin=idft_sin,
        idft_cos_plain=idft_cos_plain,
        proj_idft_cos=proj_idft_cos,
        proj_idft_sin=proj_idft_sin,
        proj_dft_cos=proj_dft_cos,
        proj_dft_sin=proj_dft_sin,
        cfmr_sq=cfmr_sq,
        cs=cs,
        ca=ca,
        leff=leff,
        spectrum_scale=spectrum_scale,
    )
