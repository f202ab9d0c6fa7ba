"""Hand-written Hopper kernels of the port, one wrapper module each.

The time-domain hop's K1 (streaming convolution), K8 (the truncated
weighting's row-wise circular convolution), K2 and K3 (lag statistics),
K6 (dense framed statistics), K10a and K9 (the 'invert' solver), K4 (the
Rayleigh-Ritz Jacobi eigensolver) and K5 (output synthesis); the
frequency-domain engine's K7 (Hermitian Jacobi, a form of K4); and K11,
the unfused circular filter (a form of K5 that no engine path calls).

Every wrapper takes float32 (K7: complex64) tensors in the layout of the
JAX Pallas function it replaces. On a CPU tensor it returns its plain PyTorch
version (``*_plain`` in the same module); on a CUDA tensor it launches
its kernel (``apvast_torch/csrc/*.cu``, built at first use) or raises,
and adds one to its ``launches`` count.
"""

from apvast_torch.ops.kernels.jacobi_eigh import jacobi_eigh, jacobi_eigh_plain
from apvast_torch.ops.kernels.jacobi_eigh_hermitian import (
    jacobi_eigh_hermitian,
    jacobi_eigh_hermitian_plain,
)
from apvast_torch.ops.kernels.lag_corr import lag_corr, lag_corr_plain
from apvast_torch.ops.kernels.output_filter import (
    circular_filter,
    circular_filter_overlap,
    circular_filter_overlap_plain,
    circular_filter_plain,
)
from apvast_torch.ops.kernels.rowwise_conv import (
    rowwise_circular_conv,
    rowwise_circular_conv_plain,
)
from apvast_torch.ops.kernels.skew_assembly import (
    lag_skew_assemble,
    lag_skew_assemble_plain,
)
from apvast_torch.ops.kernels.statistics import covariance, covariance_plain
from apvast_torch.ops.kernels.streaming_conv import (
    streaming_conv,
    streaming_conv_plain,
)
from apvast_torch.ops.kernels.subspace import subspace_iterate, subspace_iterate_plain
from apvast_torch.ops.kernels.whiten import blocked_cholesky, chol_panel, chol_panel_plain

# name -> wrapper: the time-domain hop's in its stage order, then the
# frequency-domain engine's K7, then K11, which no engine path calls.
WRAPPERS = {
    "streaming_conv": streaming_conv,
    "rowwise_conv": rowwise_circular_conv,
    "lag_corr": lag_corr,
    "skew_assembly": lag_skew_assemble,
    "statistics": covariance,
    "whiten": chol_panel,
    "subspace": subspace_iterate,
    "jacobi_eigh": jacobi_eigh,
    "output_filter": circular_filter_overlap,
    "jacobi_eigh_hermitian": jacobi_eigh_hermitian,
    "circular_filter": circular_filter,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "WRAPPERS",
    "blocked_cholesky",
    "chol_panel",
    "chol_panel_plain",
    "circular_filter",
    "circular_filter_overlap",
    "circular_filter_overlap_plain",
    "circular_filter_plain",
    "covariance",
    "covariance_plain",
    "jacobi_eigh",
    "jacobi_eigh_hermitian",
    "jacobi_eigh_hermitian_plain",
    "jacobi_eigh_plain",
    "lag_corr",
    "lag_corr_plain",
    "lag_skew_assemble",
    "lag_skew_assemble_plain",
    "launch_counts",
    "reset_launch_counts",
    "rowwise_circular_conv",
    "rowwise_circular_conv_plain",
    "streaming_conv",
    "streaming_conv_plain",
    "subspace_iterate",
    "subspace_iterate_plain",
]
