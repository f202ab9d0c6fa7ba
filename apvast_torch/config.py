"""Static configuration of the AP-VAST engine (PyTorch port).

The fields are those of ``apvast_tpu/config.py`` that a ported path
reads, with their JAX names, defaults and validation, so a configuration
of the JAX package converts field for field
(``apvast_torch.utils.convert.config_from_jax``). The JAX fields that no
ported path reads yet (the MATLAB loading factors) are not fields here;
they come with the slice that first reads them. In this package a
``use_pallas_*`` flag means "use the hand-written Hopper kernel"
(``apvast_torch/csrc/*.cu``, wrapped in ``apvast_torch/ops/kernels/``),
and ``use_matmul_dft`` means the WOLA transforms run as ``torch`` matmuls
against DFT matrices.

The port runs the time-domain hop of the JAX engine: the exact GEVD
solver (``GevdSolver.EIGH``) or a subspace solver (``GevdSolver.SUBSPACE``
with any ``subspace_whiten``: "tracking", the production solver, or the
round-3 "invert", "solve" and "newton" solvers), the FFT or kernel
streaming convolution, the exact WOLA perceptual weighting or its
truncated time-domain form (``weighting_conv_taps``, the row-wise
convolution kernel K8), dense framed statistics (plain, or the
framed-covariance kernel K6 under ``use_pallas_statistics``) or
skew-assembled lag statistics (full or half form), and the FFT or kernel
output synthesis; and the frequency-domain engine (``fd_*`` fields,
``engine/fd_hop.py``) in every mode of the JAX engine.
:func:`check_port_slice` rejects every other value (the non-skew lag
assemblies, the norm-scaled loadings and the bfloat16 knobs of
:data:`NOT_RUN`) with ``NotImplementedError`` naming the slice that
brings it; no such configuration is run another way.
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
    SUBSPACE: the warm-started top-V solvers (``subspace_whiten``)."""

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
    # SUBSPACE solver: columns beyond num_eigenvectors, power steps per
    # hop and their orthonormalization ("cholqr2"; any other value is
    # Householder QR, as in JAX, which does not validate it).
    subspace_oversample: int = 30
    subspace_iters: int = 3
    subspace_orth: str = "cholqr2"
    # Whitening. "invert": L^-1 of the loaded dark matrix once per hop
    # (ops/jdiag.jdiag_topk_batched); "solve": triangular solves per
    # application; "newton": a carried approximate inverse refreshed by
    # a Newton step, rebuilt when its residual degrades
    # (ops/jdiag.jdiag_topk_pencil_batched); "tracking": a carried
    # inverse Cholesky factor preconditions Rayleigh-Ritz tracking on the
    # exact pencil (ops/jdiag.jdiag_topk_tracked), refreshed every
    # tracking_rebuild_period hops, on the first tracking_warmup_hops hops
    # and whenever the carried Ritz residual exceeds
    # tracking_residual_rebuild (0 disables that trigger).
    subspace_whiten: str = "invert"
    tracking_outer_steps: int = 2
    tracking_rebuild_period: int = 4
    tracking_warmup_hops: int = 4
    tracking_li_bf16: bool = False
    tracking_residual_precision: str = "high"
    tracking_residual_rebuild: float = 0.0
    # "cholqr2" orthonormalizes the doubled basis [q, p]; "direct"
    # Rayleigh-Ritzes it raw, reusing A q and B q.
    tracking_rr_basis: str = "cholqr2"
    # The skew statistics hand the tracking solver M with R = M + M^T
    # (no symmetric completion pass); applied only when the skew lag
    # statistics feed the tracking solver (engine/hop.half_form).
    statistics_half_form: bool = False
    # Rayleigh-Ritz eigensolver: "jacobi" is kernel K4 (float32 only),
    # "lapack" is torch.linalg.eigh.
    small_eigh: str = "lapack"
    jacobi_sweeps: int = 4
    # 'invert' only: the fused subspace iteration (K9) and the blocked
    # Cholesky with the panel kernel (K10a, for ceil128(jl) <= 1024).
    use_pallas_subspace: bool = False
    use_pallas_whiten: bool = False
    # Dense framed statistics through the framed-covariance kernel K6
    # (float32 only); use_lag_statistics takes precedence over it.
    use_pallas_statistics: bool = False
    # Statistics from lag correlations (ops/lag_statistics.py): the
    # Toeplitz shift structure gives the same sums with ~J-fold fewer
    # operations.
    use_lag_statistics: bool = False
    lag_assembly: str = "wide"
    # Truncated time-domain perceptual weighting of the responses: a
    # circular convolution with the T-tap centre of each weighting
    # curve's impulse response (ops/weighting_conv.py, kernel K8); None
    # keeps the exact WOLA round trip.
    weighting_conv_taps: int | None = None
    # Frequency-domain engine only (engine/fd_hop.py). Per-bin filters
    # span this many STFT frames (cross-frame taps): the per-bin rank
    # ceiling becomes num_srcs * fd_frame_taps.
    fd_frame_taps: int = 1
    # Leakage-aware per-bin design: each bin's pencil uses statistics
    # smoothed over (C - 1) / 2 neighbor bins with the J-tap truncation's
    # own Dirichlet weights. Odd; 1 = the classic per-bin design.
    fd_bin_coupling: int = 1
    # Per-bin Hermitian eigensolver: "lapack" is torch.linalg.eigh,
    # "jacobi" is kernel K7 over the real 2S x 2S embedding (float32 only).
    fd_eigh: str = "lapack"
    # Cold-start Jacobi sweep count of fd_eigh="jacobi".
    fd_jacobi_sweeps: int = 6
    # "all": every cumulative rank 1..V per bin (per-bin eigendecomposition);
    # "full": only the full span, w = (A + mu B_loaded)^-1 r, one batched
    # Cholesky solve per bin and no eigendecomposition.
    fd_span: str = "all"
    # With fd_span="full": solve groups of this many adjacent bins jointly,
    # keeping the within-group leakage coupling.
    fd_group_size: int = 1
    # With fd_span="full": exact-coupling refinement iterations on the
    # global leakage-coupled normal equations, their relaxation factor
    # ("richardson") and scheme ("cg" or "richardson").
    fd_coupled_iters: int = 0
    fd_coupled_relax: float = 0.5
    fd_coupled_method: str = "cg"
    # With fd_group_size > 1: relative eigenvalue cutoff of a truncated
    # pseudo-inverse group solve; 0 = a plain solve.
    fd_group_rank_tol: float = 0.0
    # With fd_group_size > 1: also solve a half-group-shifted partition and
    # keep each bin from the pass that places it nearest a group center.
    fd_group_overlap: bool = False
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
        if self.subspace_whiten not in (
            "solve", "invert", "newton", "tracking"
        ):
            raise ValueError(
                "subspace_whiten must be one of 'solve', 'invert', "
                "'newton', 'tracking'"
            )
        if self.tracking_rebuild_period < 1:
            raise ValueError("tracking_rebuild_period must be >= 1")
        if self.tracking_li_bf16 and self.dtype != "float32":
            raise ValueError(
                "tracking_li_bf16 is a float32-production knob — it "
                "would silently degrade a float64 parity config"
            )
        if self.tracking_rr_basis not in ("cholqr2", "direct"):
            raise ValueError(
                "tracking_rr_basis must be 'cholqr2' or 'direct'"
            )
        if self.tracking_residual_precision not in ("high", "default"):
            raise ValueError(
                "tracking_residual_precision must be 'high' or 'default'"
            )
        if (
            self.tracking_residual_precision == "default"
            and self.dtype != "float32"
        ):
            raise ValueError(
                "tracking_residual_precision='default' is a float32-"
                "production knob — it would silently degrade a float64 "
                "parity config"
            )
        if self.tracking_outer_steps < 1:
            raise ValueError("tracking_outer_steps must be >= 1")
        if self.tracking_residual_rebuild < 0:
            raise ValueError("tracking_residual_rebuild must be >= 0")
        if self.lag_assembly not in ("wide", "pair", "tap", "skew"):
            raise ValueError(
                "lag_assembly must be one of 'wide', 'pair', 'tap', 'skew'"
            )
        if self.fd_frame_taps < 1:
            raise ValueError("fd_frame_taps must be >= 1")
        if self.fd_bin_coupling < 1 or self.fd_bin_coupling % 2 != 1:
            raise ValueError("fd_bin_coupling must be odd and >= 1")
        if self.fd_span not in ("all", "full"):
            raise ValueError("fd_span must be 'all' or 'full'")
        if self.fd_group_size < 1:
            raise ValueError("fd_group_size must be >= 1")
        if self.fd_coupled_iters < 0:
            raise ValueError("fd_coupled_iters must be >= 0")
        if self.fd_coupled_iters > 0:
            if self.fd_span != "full":
                raise ValueError(
                    "fd_coupled_iters refines the full-span solution — "
                    "it requires fd_span='full'"
                )
            if self.fd_group_size > 1:
                raise ValueError(
                    "fd_coupled_iters and fd_group_size are alternative "
                    "coupled formulations — enable only one"
                )
        if not 0.0 < self.fd_coupled_relax <= 1.0:
            raise ValueError("fd_coupled_relax must be in (0, 1]")
        if self.fd_coupled_method not in ("cg", "richardson"):
            raise ValueError("fd_coupled_method must be 'cg' or 'richardson'")
        if self.fd_group_size > 1:
            if self.fd_span != "full":
                raise ValueError(
                    "fd_group_size > 1 is the group-coupled full-span "
                    "solve — it requires fd_span='full' (the variable-"
                    "span 'all' path has no group formulation)"
                )
            if self.fd_bin_coupling <= 1:
                raise ValueError(
                    "fd_group_size > 1 needs fd_bin_coupling > 1: the "
                    "coupling window is the leakage sum the group blocks "
                    "are built from"
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
    def subspace_rank(self) -> int:
        """Columns of the tracked subspace (SUBSPACE solver)."""
        return min(self.num_eigenvectors + self.subspace_oversample, self.jl)

    @property
    def num_solutions(self) -> int:
        return (
            len(self.output_spans)
            if self.output_spans is not None
            else self.num_eigenvectors
        )

    @property
    def fd_num_solutions(self) -> int:
        """Leading output-rank axis of the FD engine: 1 in the full-span
        mode, else every cumulative rank 1..V."""
        return 1 if self.fd_span == "full" else self.num_eigenvectors

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


def uses_tracking_solver(config: ApVastConfig) -> bool:
    """Whether the hop runs the tracking GEVD solver (and carries its
    state)."""
    return (
        config.gevd_solver is GevdSolver.SUBSPACE
        and config.subspace_whiten == "tracking"
    )


def uses_subspace_solver(config: ApVastConfig) -> bool:
    """Whether the hop runs a subspace GEVD solver (and carries its basis
    ``gevd_q``)."""
    return config.gevd_solver is GevdSolver.SUBSPACE


def production_overrides() -> dict:
    """The values of the JAX package's ``production_overrides("tpu")`` for
    the port's fields: float32, the tracking subspace solver with the
    Jacobi Rayleigh-Ritz kernel, skew-assembled half-form lag statistics
    and every kernel flag on. The exact-solver oracle is
    ``production_overrides() | {"gevd_solver": GevdSolver.EIGH}``; the
    round-3 production solver adds ``{"subspace_whiten": "invert",
    "jacobi_sweeps": 3, "use_pallas_subspace": True, "use_pallas_whiten":
    True}``."""
    return dict(
        dtype="float32",
        gevd_solver=GevdSolver.SUBSPACE,
        subspace_oversample=14,
        subspace_iters=2,
        subspace_whiten="tracking",
        tracking_outer_steps=1,
        tracking_rebuild_period=32,
        tracking_warmup_hops=6,
        tracking_rr_basis="direct",
        tracking_residual_rebuild=2.5,
        use_lag_statistics=True,
        lag_assembly="skew",
        statistics_half_form=True,
        use_pallas_statistics=True,
        use_pallas_output=True,
        use_pallas_conv=True,
        use_matmul_dft=True,
        small_eigh="jacobi",
        jacobi_sweeps=2,
    )


# Values of port fields that no ported path runs: field -> (value, the
# slice of ROADMAP.md that brings it).
NOT_RUN = {
    "tracking_li_bf16": (True, "a bfloat16 preconditioner carry, a later slice of the port"),
    "tracking_residual_precision": (
        "default", "single-pass bf16 residual products of the TPU, a later slice of the port"
    ),
}


def check_not_run(fields) -> None:
    """Raise ``NotImplementedError`` if the mapping ``fields`` sets a value
    of :data:`NOT_RUN`."""
    for name, (value, where) in NOT_RUN.items():
        if fields.get(name) == value:
            raise NotImplementedError(f"{name}={value!r} comes with {where}")


def check_port_slice(config: ApVastConfig) -> None:
    """Raise ``NotImplementedError`` for a value the port does not run,
    naming the slice of ``ROADMAP.md`` that brings it."""
    if config.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be 'float32' or 'float64', got {config.dtype!r}")
    check_not_run(vars(config))
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
