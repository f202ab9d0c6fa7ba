"""Setup-time constants of the van de Par (2005) detectability model, the
perceptual weighting that the reference recomputes in float64.

A frozen copy of the port's ``perceptual/tables.py`` (itself a copy of the
JAX package's), so that the reference imports nothing of either package
and a later change to the program cannot move the yardstick. Threshold
methods are named by string: "iso226_2003" (the configurations'),
"painter_2000" or "none".

Re-derives, from the paper's equations:

* threshold of hearing (ISO 226:2003 spline / Painter-2000 closed form),
* the outer-middle-ear response as its reciprocal,
* a 1-ERB-spaced, 1-ERB-wide 4th-order gammatone magnitude bank,
* the effective-duration factor L_eff = min(N / Fs / 0.3, 1),
* the calibration constants (Cs, Ca) chosen so that a 52 dB SPL probe at
  the masked threshold of a 70 dB SPL on-frequency masker has
  detectability exactly 1 (solved by bisection, as in the paper).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.interpolate import CubicSpline


# ISO 226:2003 free-field threshold-of-hearing anchor points
# (interpolatedThresholdOfHearing.m:29-30).
_ISO226_FREQ = np.array(
    [20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0, 200.0,
     250.0, 315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0, 1600.0,
     2000.0, 2500.0, 3150.0, 4000.0, 5000.0, 6300.0, 8000.0, 10000.0,
     12500.0]
)
_ISO226_SPL = np.array(
    [78.5, 68.7, 59.5, 51.1, 44.0, 37.5, 31.5, 26.5, 22.1, 17.9, 14.4,
     11.4, 8.6, 6.2, 4.4, 3.0, 2.2, 2.4, 3.5, 1.7, -1.3, -4.2, -6.0,
     -5.4, -1.5, 6.0, 12.6, 13.9, 12.3]
)

_REFERENCE_PRESSURE_PA = 20e-6


def threshold_of_hearing_db(
    frequency: np.ndarray, method: str = "iso226_2003"
) -> np.ndarray:
    """Threshold of hearing in dB SPL at the given frequencies
    (interpolatedThresholdOfHearing.m:11-21)."""
    frequency = np.asarray(frequency, dtype=np.float64)
    if method == "none":
        return np.zeros_like(frequency)
    if method == "painter_2000":
        khz = frequency / 1000.0
        with np.errstate(divide="ignore"):
            return (
                3.64 * khz ** (-0.8)
                - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
                + 1e-3 * khz**4
            )
    # MATLAB interp1(..., 'spline') is a not-a-knot cubic spline with
    # spline extrapolation outside the table — CubicSpline's default.
    spline = CubicSpline(_ISO226_FREQ, _ISO226_SPL, bc_type="not-a-knot")
    return spline(frequency)


def _erb_scale(frequency_hz: np.ndarray) -> np.ndarray:
    """Hz -> ERB-number scale (gammatoneFilterResponse.m:37)."""
    f = np.asarray(frequency_hz, dtype=np.float64)
    return 9.2645 * np.sign(f) * np.log(1.0 + np.abs(f) * 0.00437)


def _erb_to_hz(erb: np.ndarray) -> np.ndarray:
    """ERB-number scale -> Hz (gammatoneFilterResponse.m:49)."""
    erb = np.asarray(erb, dtype=np.float64)
    return (1.0 / 0.00437) * np.sign(erb) * (np.expm1(np.abs(erb) / 9.2645))


def gammatone_center_frequencies(f_low: float, f_high: float):
    """1-ERB-spaced center frequencies and bandwidths covering
    [f_low, f_high] (gammatoneFilterResponse.m:32-52)."""
    limits = _erb_scale(np.array([f_low, f_high]))
    erb_range = limits[1] - limits[0]
    n = int(math.floor(erb_range))
    # Center the n+1 points inside the range.
    points = limits[0] + np.arange(n + 1) + (erb_range - n) / 2.0
    centers = _erb_to_hz(points)
    bandwidths = 24.7 + centers / 9.265
    return centers, bandwidths


def _gammatone_responses(
    centers: np.ndarray, bandwidths: np.ndarray, frequency: np.ndarray
) -> np.ndarray:
    """4th-order gammatone magnitude responses for given center/ERB
    grids, shape (bins, channels) — the shared evaluation behind both
    front-end parameterizations (gammatoneFilterResponse.m:7-19)."""
    order = 4
    # k = 2^(n-1) (n-1)! / (pi (2n-3)!!) relates the -3 dB bandwidth of a
    # gammatone filter to its ERB; for n = 4, (2n-3)!! = 5!! = 15.
    double_fact = float(np.prod(np.arange(2 * order - 3, 0, -2)))
    k = 2.0 ** (order - 1) * math.factorial(order - 1) / (math.pi * double_fact)
    f = np.asarray(frequency, dtype=np.float64)[:, None]
    detune = (f - centers[None, :]) / (k * bandwidths[None, :])
    return (1.0 + detune**2) ** (-order / 2.0)


def gammatone_magnitude_bank(
    f_low: float, f_high: float, frequency: np.ndarray
) -> np.ndarray:
    """Responses on the MATLAB model's 1-ERB-spaced center grid."""
    centers, bandwidths = gammatone_center_frequencies(f_low, f_high)
    return _gammatone_responses(centers, bandwidths, frequency)


@dataclasses.dataclass(frozen=True)
class PerceptualTables:
    """Device-ready constants of the calibrated model."""

    # (bins, channels): squared outer-middle-ear * gammatone response.
    cfmr_sq: np.ndarray
    # (channels,): squared gammatone-only response summed into K at the
    # calibration bin is folded into ca already; kept for diagnostics.
    num_channels: int
    cs: float
    ca: float
    leff: float
    # sqrt(2)/N — the model's internal spectrum scaling
    # (perceptualModel.m:132, apVast.m:213).
    spectrum_scale: float


def build_perceptual_tables(
    block_size: int,
    sampling_rate: float,
    pressure_scale_db_spl: float,
    threshold_method: str = "iso226_2003",
    bank: np.ndarray | None = None,
) -> PerceptualTables:
    """Build and calibrate the model for one (block, Fs, SPL-scale) triple
    (perceptualModel.m:30-116). ``bank`` overrides the gammatone bank
    (default: the MATLAB model's 1-ERB-spaced bank)."""
    if block_size % 2 != 0:
        raise ValueError("block_size must be even")
    fullscale_pa = 10.0 ** (pressure_scale_db_spl / 20.0) * _REFERENCE_PRESSURE_PA
    frequency = np.arange(block_size // 2 + 1) * (sampling_rate / block_size)

    toh_db = threshold_of_hearing_db(frequency, threshold_method)
    toh_digital = 10.0 ** (toh_db / 20.0) * _REFERENCE_PRESSURE_PA / fullscale_pa
    with np.errstate(divide="ignore"):
        outer_middle_ear = 1.0 / toh_digital

    if bank is None:
        bank = gammatone_magnitude_bank(0.0, sampling_rate / 2.0, frequency)
    cfmr = outer_middle_ear[:, None] * bank
    leff = min(block_size / sampling_rate / 0.3, 1.0)

    # --- calibration: 52 dB SPL probe masked by a 70 dB SPL tone --------
    # Amplitudes relative to digital full scale; a bin-centered sine of
    # amplitude A has one-sided scaled-spectrum magnitude A/sqrt(2) under
    # the sqrt(2)/N scaling (perceptualModel.m:62-76).
    # MATLAB picks frequency(floor(N/48)) (1-based); clamp away from the
    # DC bin so tiny test block sizes stay calibratable.
    bin_index = max(1, block_size // 48 - 1)
    a52 = math.sqrt(2.0) * 10.0 ** (52.0 / 20.0) * _REFERENCE_PRESSURE_PA / fullscale_pa
    a70 = math.sqrt(2.0) * 10.0 ** (70.0 / 20.0) * _REFERENCE_PRESSURE_PA / fullscale_pa
    s52 = a52 / math.sqrt(2.0)
    s70 = a70 / math.sqrt(2.0)

    k_norm = float(np.sum(bank[bin_index, :] ** 2)) * leff
    k52 = cfmr[bin_index, :] ** 2 * s52**2
    k70 = cfmr[bin_index, :] ** 2 * s70**2

    def objective(x: float) -> float:
        return leff * float(np.sum(k52 / (k70 + x * k_norm))) - 1.0 / x

    lo, hi = 1e-1, 200.0
    if objective(hi) < 0.0:
        hi = 1000.0
    if np.sign(objective(lo)) == np.sign(objective(hi)):
        raise RuntimeError("perceptual calibration bracketing failed")
    for _ in range(1000):
        mid = 0.5 * (lo + hi)
        f_mid = objective(mid)
        if f_mid == 0.0 or (hi - lo) / 2.0 < 1e-6:
            break
        if np.sign(f_mid) == np.sign(objective(lo)):
            lo = mid
        else:
            hi = mid
    cs = mid
    ca = cs * k_norm

    return PerceptualTables(
        cfmr_sq=cfmr**2,
        num_channels=bank.shape[1],
        cs=float(cs),
        ca=float(ca),
        leff=float(leff),
        spectrum_scale=math.sqrt(2.0) / block_size,
    )
