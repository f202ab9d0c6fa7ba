"""Setup-time constants of the van de Par (2005) detectability model.

Re-derives, from the paper's equations, the quantities the reference builds
in Matlab/ControlMethods/perceptualModel.m:30-116,
gammatoneFilterResponse.m and interpolatedThresholdOfHearing.m:

* threshold of hearing (ISO 226:2003 spline / Painter-2000 closed form),
* the outer-middle-ear response as its reciprocal,
* a 1-ERB-spaced, 1-ERB-wide 4th-order gammatone magnitude bank,
* the effective-duration factor L_eff = min(N / Fs / 0.3, 1),
* the calibration constants (Cs, Ca) chosen so that a 52 dB SPL probe at
  the masked threshold of a 70 dB SPL on-frequency masker has
  detectability exactly 1 (solved by bisection, as in the paper).

Everything here runs once per configuration in NumPy float64; the results
are shipped to the device as constants inside the engine plan. No runtime
bisection ever happens inside the hop.

This module is a copy of ``apvast_tpu/perceptual/tables.py`` (pure NumPy),
kept here so that the port imports nothing of the JAX package.

The Python reference delegates this model to the external
``libdetectability`` package (Python/apvast.py:4,77-83) which is the same
van de Par math; this module is the framework's own implementation, so the
perceptual path has no external dependency.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.interpolate import CubicSpline

from apvast_torch.config import ThresholdMethod

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
    frequency: np.ndarray, method: ThresholdMethod = ThresholdMethod.ISO226_2003
) -> np.ndarray:
    """Threshold of hearing in dB SPL at the given frequencies
    (interpolatedThresholdOfHearing.m:11-21)."""
    frequency = np.asarray(frequency, dtype=np.float64)
    if method is ThresholdMethod.NONE:
        return np.zeros_like(frequency)
    if method is ThresholdMethod.PAINTER_2000:
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


def fixed_taps_gammatone_bank(
    taps: int, sampling_rate: float, frequency: np.ndarray
) -> np.ndarray:
    """4th-order gammatone magnitude responses with a FIXED channel count:
    ``taps`` center frequencies spread uniformly on the ERB-number scale
    over (0, Fs/2), each 1 ERB wide — the ``libdetectability``
    parameterization (Python/apvast.py:79 passes taps=32) as opposed to
    the MATLAB model's 1-ERB spacing with a rate-dependent channel count
    (gammatoneFilterResponse.m:32-52). Shape (bins, taps)."""
    top = _erb_scale(np.array([sampling_rate / 2.0]))[0]
    points = (np.arange(taps) + 0.5) * (top / taps)
    centers = _erb_to_hz(points)
    bandwidths = 24.7 + centers / 9.265
    return _gammatone_responses(centers, bandwidths, frequency)


def build_perceptual_tables(
    block_size: int,
    sampling_rate: float,
    pressure_scale_db_spl: float,
    threshold_method: ThresholdMethod = ThresholdMethod.ISO226_2003,
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


def build_libdetectability_tables(
    block_size: int,
    sampling_rate: float,
    taps: int = 32,
) -> PerceptualTables:
    """Calibrated tables with the ``libdetectability`` parameterization
    that the Python reference wires in (Python/apvast.py:4,77-83):

    * ``taps`` FIXED gammatone channels uniform on the ERB scale (the
      package's constructor takes a channel count, not a spacing),
    * the Terhardt/Painter-2000 closed-form threshold of hearing (the
      package has no ISO table), and
    * ``relax_threshold=True`` semantics: the reference's own comments
      state dbspl/spl are ignored under it, i.e. no absolute digital <->
      SPL mapping exists. The model is therefore referenced to the
      threshold-curve minimum: digital amplitude 1 sits at the
      most-sensitive frequency's threshold, which makes the outer-middle-
      ear response a pure normalized threshold *shape* while keeping both
      van de Par calibration conditions (70 dB masker / 52 dB probe at
      masked threshold; threshold-level tone in quiet at D = 1)
      meaningful — they only involve levels *relative to* threshold.

    The package itself is unavailable offline (survey §6), so exact
    numerical equality with it is unverifiable here; this reconstruction
    pins the documented constructor surface + the paper's equations and
    is validated against an independent NumPy oracle in
    tests/test_perceptual_frontend.py.
    """
    frequency = np.arange(block_size // 2 + 1) * (sampling_rate / block_size)
    toh_db = threshold_of_hearing_db(frequency, ThresholdMethod.PAINTER_2000)
    # Reference level = the minimum of the threshold curve over the
    # represented band (DC diverges in the Terhardt form; exclude it).
    thr_min_db = float(np.min(toh_db[1:]))
    bank = fixed_taps_gammatone_bank(taps, sampling_rate, frequency)
    # With pressure_scale = thr_min, the absolute-SPL construction
    # degenerates to the relative-threshold one: toh_digital becomes
    # 10**((toh - thr_min)/20) and the calibration tones 10**((52|70 -
    # thr_min)/20) — no 20 uPa reference survives.
    return build_perceptual_tables(
        block_size,
        sampling_rate,
        pressure_scale_db_spl=thr_min_db,
        threshold_method=ThresholdMethod.PAINTER_2000,
        bank=bank,
    )
