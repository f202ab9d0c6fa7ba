"""Static configuration of the AP-VAST engine (PyTorch port).

The fields are those of ``apvast_tpu/config.py`` that a ported path
reads, with their JAX names, defaults and validation, so a configuration
of the JAX package converts field for field
(``apvast_torch.utils.convert.config_from_jax``). The JAX fields that no
ported path reads yet (the subspace solver's knobs, the frequency-domain
engine's, the MATLAB loading factors) are not fields here; each comes
with the slice that first reads it. In this package a ``use_pallas_*``
flag means "use the hand-written Hopper kernel"
(``apvast_torch/csrc/*.cu``, wrapped in ``apvast_torch/ops/kernels/``),
and ``use_matmul_dft`` means the WOLA transforms run as ``torch`` matmuls
against DFT matrices.

The port runs one slice of the JAX engine so far: the time-domain hop
with the exact GEVD solver (``GevdSolver.EIGH``), the FFT or kernel
streaming convolution, dense or skew-assembled lag statistics and the
FFT or kernel output synthesis. :func:`check_port_slice` rejects every
other value with ``NotImplementedError`` naming the slice that brings it;
no such configuration is run another way.
"""

from __future__ import annotations

import dataclasses
import enum


class ToeplitzVariant(enum.Enum):
    """How statistics frames are read out of the weighted-response
    buffers. PYTHON: scipy's ``toeplitz`` corner override skips the buffer
    sample at index J (N - J frames). MATLAB: contiguous frames
    (N - J + 1 of them)."""

    PYTHON = "python"
    MATLAB = "matlab"


class RegularizationVariant(enum.Enum):
    """Where diagonal loading is applied before the joint
    diagonalization: PYTHON loads B with a fixed ``reg_b``; PYTHON_NORM and
    MATLAB use spectral-norm-scaled loading."""

    PYTHON = "python"
    PYTHON_NORM = "python_norm"
    MATLAB = "matlab"


class WeightingNorm(enum.Enum):
    """Normalization of the perceptual weighting curve per microphone."""

    UNIT_ONESIDED = "unit_onesided"
    UNIT_SYMMETRIC = "unit_symmetric"
    PRESSURE = "pressure"
    NONE = "none"


class TargetFilterVariant(enum.Enum):
    """SHARED_A: one delta target filter from ``reference_index_a`` for
    both zones. PER_ZONE: each zone's own reference index."""

    SHARED_A = "shared_a"
    PER_ZONE = "per_zone"


class GevdSolver(enum.Enum):
    """EIGH: exact dense eigendecomposition after Cholesky whitening.
    SUBSPACE: the warm-started top-V solvers (a later slice of the port)."""

    EIGH = "eigh"
    SUBSPACE = "subspace"


class ThresholdMethod(enum.Enum):
    """Threshold-of-hearing curve of the perceptual model."""

    ISO226_2003 = "iso226_2003"
    PAINTER_2000 = "painter_2000"
    NONE = "none"


class PerceptualFrontend(enum.Enum):
    """MATLAB_MODEL: 1-ERB-spaced gammatone channels with absolute SPL
    calibration. LIBDETECTABILITY: ``perceptual_taps`` fixed channels,
    Painter-2000 threshold referenced to its minimum."""

    MATLAB_MODEL = "matlab_model"
    LIBDETECTABILITY = "libdetectability"


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class ApVastConfig:
    """Hashable description of an AP-VAST processing scene. Field meanings
    are those of ``apvast_tpu.config.ApVastConfig``."""

    rir_length: int
    num_srcs: int
    num_mics: int

    block_size: int = 1600
    filter_length: int = 100
    modeling_delay: int = 20
    reference_index_a: int = 0
    reference_index_b: int = 0
    num_eigenvectors: int = 1
    mu: float = 1.0
    statistics_buffer_length: int = 1000
    hop_size: int | None = None
    sampling_rate: int = 48000
    run_a: bool = True
    run_b: bool = True
    perceptual: bool = True

    dtype: str = "float64"
    toeplitz_variant: ToeplitzVariant = ToeplitzVariant.PYTHON
    regularization: RegularizationVariant = RegularizationVariant.PYTHON
    reg_b: float = 1e-7
    # None = AUTO: 1e-6 scale-relative dark loading for float32, 0 for
    # float64 (see effective_reg_b_relative).
    reg_b_relative: float | None = None
    normalize_statistics: bool = False
    weighting_norm: WeightingNorm = WeightingNorm.UNIT_ONESIDED
    target_filter: TargetFilterVariant = TargetFilterVariant.SHARED_A
    threshold_method: ThresholdMethod = ThresholdMethod.ISO226_2003
    perceptual_frontend: PerceptualFrontend = PerceptualFrontend.MATLAB_MODEL
    perceptual_taps: int = 32
    gevd_solver: GevdSolver = GevdSolver.EIGH
    # Dense framed statistics kernel; in production only a fallback that
    # use_lag_statistics takes precedence over.
    use_pallas_statistics: bool = False
    # Statistics from lag correlations (ops/lag_statistics.py): the
    # Toeplitz shift structure gives the same sums with ~J-fold fewer
    # operations.
    use_lag_statistics: bool = False
    lag_assembly: str = "wide"
    weighting_conv_taps: int | None = None
    # Output synthesis through the circular-filter kernel (K5).
    use_pallas_output: bool = False
    # Stage-1 RIR convolution through the streaming-convolution kernel (K1).
    use_pallas_conv: bool = False
    # WOLA transforms as matmuls against DFT matrices with the windows
    # folded in, instead of FFTs.
    use_matmul_dft: bool = False
    output_spans: tuple[int, ...] | None = None
    pressure_scale_db_spl: float = 94.0
    noise_init_scale: float = 1e-3

    def __post_init__(self) -> None:
        if self.block_size % 2 != 0:
            raise ValueError("block_size must be even")
        if self.hop_size is not None and not 0 < self.hop_size <= self.block_size:
            raise ValueError("hop_size must lie in (0, block_size]")
        if self.statistics_buffer_length <= self.filter_length:
            raise ValueError(
                "statistics_buffer_length must exceed filter_length"
            )
        if not 0 <= self.modeling_delay < self.filter_length:
            raise ValueError("modeling_delay must lie in [0, filter_length)")
        if not 0 <= self.reference_index_a < self.num_srcs:
            raise ValueError("reference_index_a out of range")
        if not 0 <= self.reference_index_b < self.num_srcs:
            raise ValueError("reference_index_b out of range")
        if self.num_eigenvectors > self.filter_length * self.num_srcs:
            raise ValueError("num_eigenvectors exceeds JL")
        if self.weighting_conv_taps is not None:
            t = self.weighting_conv_taps
            if t % 2 != 1 or not 0 < t < self.block_size:
                raise ValueError(
                    "weighting_conv_taps must be odd and in (0, block_size)"
                )
        if self.lag_assembly not in ("wide", "pair", "tap", "skew"):
            raise ValueError(
                "lag_assembly must be one of 'wide', 'pair', 'tap', 'skew'"
            )
        if self.output_spans is not None:
            if len(self.output_spans) == 0:
                raise ValueError("output_spans must be non-empty")
            if any(
                not 1 <= v <= self.num_eigenvectors for v in self.output_spans
            ):
                raise ValueError(
                    "output_spans entries must lie in [1, num_eigenvectors]"
                )

    # ---- derived static quantities -------------------------------------

    @property
    def hop(self) -> int:
        return self.hop_size if self.hop_size is not None else self.block_size // 2

    @property
    def carried_deleted_statistics(self) -> bool:
        """Whether the state carries the statistics buffer in sample-J-
        deleted form: PYTHON Toeplitz variant, hop > J (the deleted sample
        slides out of the window before the next hop) and
        hop + J <= statistics_buffer_length."""
        return (
            self.toeplitz_variant is ToeplitzVariant.PYTHON
            and self.hop > self.filter_length
            and self.hop + self.filter_length <= self.statistics_buffer_length
        )

    @property
    def effective_reg_b_relative(self) -> float:
        if self.reg_b_relative is not None:
            return self.reg_b_relative
        return 1e-6 if self.dtype == "float32" else 0.0

    @property
    def num_bins(self) -> int:
        return self.block_size // 2 + 1

    @property
    def jl(self) -> int:
        return self.filter_length * self.num_srcs

    @property
    def num_solutions(self) -> int:
        return (
            len(self.output_spans)
            if self.output_spans is not None
            else self.num_eigenvectors
        )

    @property
    def num_frames(self) -> int:
        n, j = self.statistics_buffer_length, self.filter_length
        return n - j if self.toeplitz_variant is ToeplitzVariant.PYTHON else n - j + 1

    @property
    def fir_fft_size(self) -> int:
        return _next_pow2(self.rir_length + self.hop - 1)

    @property
    def fir_history(self) -> int:
        return self.fir_fft_size - self.hop

    @classmethod
    def for_rirs(cls, rir_a, rir_b, **kwargs) -> "ApVastConfig":
        """Config whose geometry matches a RIR pair laid out
        ``(rir_length, num_srcs, num_mics)``."""
        if rir_a.shape != rir_b.shape:
            raise ValueError("rirs of unequal size")
        rl, ns, nm = rir_a.shape
        return cls(rir_length=rl, num_srcs=ns, num_mics=nm, **kwargs)


def production_overrides() -> dict:
    """The values of the JAX package's ``production_overrides("tpu")`` for
    the port's fields: float32, the subspace solver, skew-assembled lag
    statistics and every kernel flag on. The solver's own knobs in the
    JAX dict come with slice 2 of the port (``utils/convert.py`` keeps
    their production values).

    The port's current slice composes this with the exact solver,
    :func:`slice_overrides`.
    """
    return dict(
        dtype="float32",
        gevd_solver=GevdSolver.SUBSPACE,
        use_lag_statistics=True,
        lag_assembly="skew",
        use_pallas_statistics=True,
        use_pallas_output=True,
        use_pallas_conv=True,
        use_matmul_dft=True,
    )


def slice_overrides() -> dict:
    """The configuration this slice of the port runs end to end: the
    production values with the exact GEVD solver."""
    return production_overrides() | {"gevd_solver": GevdSolver.EIGH}


def check_port_slice(config: ApVastConfig) -> None:
    """Raise ``NotImplementedError`` for a value this slice of the port
    does not run, naming the slice of ``ROADMAP.md`` that brings it."""
    if config.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be 'float32' or 'float64', got {config.dtype!r}")
    if config.gevd_solver is GevdSolver.SUBSPACE:
        raise NotImplementedError(
            "GevdSolver.SUBSPACE (the tracking solver with the Jacobi "
            "eigensolver kernel) comes with slice 2 of the port; use "
            "GevdSolver.EIGH"
        )
    if config.weighting_conv_taps is not None:
        raise NotImplementedError(
            "weighting_conv_taps (truncated time-domain weighting with the "
            "row-wise convolution kernel) is a later slice of the port"
        )
    if config.regularization is not RegularizationVariant.PYTHON:
        raise NotImplementedError(
            "norm-scaled loading (PYTHON_NORM / MATLAB regularization) "
            "comes with the MATLAB-variant slice of the port"
        )
    if config.use_lag_statistics and config.lag_assembly != "skew":
        raise NotImplementedError(
            f"lag_assembly={config.lag_assembly!r} is one of the kept "
            "experimental assemblies, a later slice of the port; use 'skew'"
        )
    if config.use_pallas_statistics and not config.use_lag_statistics:
        raise NotImplementedError(
            "dense use_pallas_statistics without lag statistics needs the "
            "framed-covariance kernel, a later slice of the port"
        )
