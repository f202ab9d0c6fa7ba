"""Per-frame perceptual weighting (van de Par 2005 detectability model).

Port of ``apvast_tpu/perceptual/model.py``. The squared weighting curve is
    w^2(f) = Cs * Leff * sum_ch g_ch^2(f) / (P_ch + Ca)
with per-channel masker power P_ch = sum_f g_ch^2(f) |S(f)|^2, where g_ch
is the combined outer-middle-ear x gammatone response and S the
sqrt(2)/N-scaled masker spectrum. Both sums are matmuls against the
precomputed (bins, channels) table.
"""

from __future__ import annotations

import torch

from apvast_torch.config import WeightingNorm


def squared_weighting(
    spectra: torch.Tensor,
    cfmr_sq: torch.Tensor,
    cs: float,
    ca: float,
    leff: float,
    spectrum_scale: float,
) -> torch.Tensor:
    """Un-normalized squared weighting curve of raw rfft masker spectra
    ``(..., bins)``."""
    power = (spectra * spectrum_scale).abs() ** 2
    masker = power @ cfmr_sq  # (..., channels)
    return (cs * leff) * ((1.0 / (masker + ca)) @ cfmr_sq.T)


def perceptual_gain(
    spectra: torch.Tensor,
    cfmr_sq: torch.Tensor,
    cs: float,
    ca: float,
    leff: float,
    spectrum_scale: float,
    norm: WeightingNorm,
) -> torch.Tensor:
    """Weighting gains ``(..., bins)`` for raw one-sided masker spectra;
    ``norm`` selects the post-normalization (see WeightingNorm)."""
    gain = torch.sqrt(
        squared_weighting(spectra, cfmr_sq, cs, ca, leff, spectrum_scale)
    )
    if norm is WeightingNorm.UNIT_ONESIDED:
        gain = gain / torch.linalg.vector_norm(gain, dim=-1, keepdim=True)
    elif norm is WeightingNorm.UNIT_SYMMETRIC:
        # Norm of the length-N symmetric extension: interior bins twice.
        sym_sq = (gain**2).sum(-1, keepdim=True) + (gain[..., 1:-1] ** 2).sum(
            -1, keepdim=True
        )
        gain = gain / torch.sqrt(sym_sq)
    elif norm is WeightingNorm.PRESSURE:
        gain = gain * 20e-6
    return gain


def detectability(test_spectra: torch.Tensor, masker_gain_sq: torch.Tensor) -> torch.Tensor:
    """Detectability D = sum_{f>0} w^2(f) |T(f)|^2 of a test signal under a
    masker's squared weighting curve. ``test_spectra`` (..., bins): rfft of
    the test block already scaled by sqrt(2)/N; ``masker_gain_sq`` (...,
    bins): the un-normalized squared weighting (:func:`squared_weighting`).
    The DC bin is left out, as in the reference."""
    power = test_spectra.abs() ** 2
    return (masker_gain_sq[..., 1:] * power[..., 1:]).sum(-1)
