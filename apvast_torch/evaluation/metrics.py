"""Evaluation metrics of the reference demo (port of
``apvast_tpu/evaluation/metrics.py``): predicted zone pressure, acoustic
contrast, NMSE and perceptual detectability. Computed in the dtype and on
the device of the inputs.
"""

from __future__ import annotations

import torch

from apvast_torch.config import _next_pow2
from apvast_torch.ops.wola import irfft_batched, rfft_batched
from apvast_torch.perceptual.model import detectability as _detectability
from apvast_torch.perceptual.model import squared_weighting


def predict_pressure(loudspeaker_signals, rirs) -> torch.Tensor:
    """Predicted zone pressure.

    Args:
        loudspeaker_signals: (..., T, srcs) feeds (leading batch axes
            allowed, e.g. the rank axis of the all-spans output).
        rirs: (rir_length, srcs, mics), converted to the feeds' dtype and
            device.

    Returns:
        (..., T, mics): the sum over sources of signal (*) rir, truncated
        to T samples as scipy/MATLAB ``filter`` does.
    """
    sig = torch.as_tensor(loudspeaker_signals)
    rirs = torch.as_tensor(rirs).to(device=sig.device, dtype=sig.dtype)
    t = sig.shape[-2]
    nfft = _next_pow2(t + rirs.shape[0] - 1)
    sig_spec = rfft_batched(sig.transpose(-1, -2), nfft)  # (..., srcs, bins)
    rir_spec = rfft_batched(rirs.permute(1, 2, 0), nfft)  # (srcs, mics, bins)
    prod = torch.einsum("...sf,smf->...mf", sig_spec, rir_spec)
    return irfft_batched(prod, nfft)[..., :t].transpose(-1, -2)


def acoustic_contrast_db(bright_pressure, dark_pressure) -> torch.Tensor:
    """10 log10(||p_bright||_F^2 / ||p_dark||_F^2) over the last two axes
    (..., T, mics)."""
    num = (torch.as_tensor(bright_pressure) ** 2).sum((-2, -1))
    den = (torch.as_tensor(dark_pressure) ** 2).sum((-2, -1))
    return 10.0 * torch.log10(num / den)


def normalized_mse(pressure, target_pressure) -> torch.Tensor:
    """Mic-averaged NMSE against the target pressure; inputs (..., T, mics)."""
    pressure, target_pressure = torch.as_tensor(pressure), torch.as_tensor(target_pressure)
    err = ((target_pressure - pressure) ** 2).sum(-2)
    ref = (target_pressure**2).sum(-2)
    return (err / ref).mean(-1)


def detectability(test_blocks, masker_blocks, tables) -> torch.Tensor:
    """Perceptual detectability D = sum_{f>0} w_masker^2(f) |T(f)|^2 per
    block of test signal blocks under masker blocks.

    Args:
        test_blocks: (..., block) time blocks of the signal to judge (e.g.
            reproduction error or dark-zone leakage).
        masker_blocks: (..., block) time blocks of the masking signal (e.g.
            the target-zone pressure), on the device of ``test_blocks``.
        tables: a :class:`apvast_torch.perceptual.tables.PerceptualTables`
            for the block length.

    Returns (...,): D = 1 is the masked threshold by calibration; D >> 1 is
    clearly audible.
    """
    test_blocks = torch.as_tensor(test_blocks)
    masker_blocks = torch.as_tensor(masker_blocks).to(test_blocks.device)
    cfmr_sq = torch.as_tensor(tables.cfmr_sq, dtype=test_blocks.dtype,
                              device=test_blocks.device)
    masker_spec = rfft_batched(masker_blocks, masker_blocks.shape[-1])
    w_sq = squared_weighting(masker_spec, cfmr_sq, tables.cs, tables.ca, tables.leff,
                             tables.spectrum_scale)
    test_spec = rfft_batched(test_blocks, test_blocks.shape[-1]) * tables.spectrum_scale
    return _detectability(test_spec, w_sq)
