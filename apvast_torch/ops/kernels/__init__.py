"""Hand-written Hopper kernels of the port, one wrapper module each.

The time-domain hop's K1 (streaming convolution), K8 (the truncated
weighting's row-wise circular convolution), K2 and K3 (lag statistics),
K6 (dense framed statistics), K10a and K9 (the 'invert' solver), K4 (the
Rayleigh-Ritz Jacobi eigensolver) with the tracking solver's Rayleigh-Ritz
solve before it and its Ritz coordinates after it (``tracked_rr``, which
replaces no Pallas kernel), and K5 (output synthesis); the
frequency-domain engine's K7 (Hermitian Jacobi, a form of K4); and two
kernels that no engine path calls, as in the JAX package: K11, the unfused
circular filter (a form of K5), and K10b, the fused Cholesky and
triangular inverse.

Every wrapper takes float32 (K7: complex64) tensors in the layout of the
JAX Pallas function it replaces. On a CPU tensor it returns its plain PyTorch
version (``*_plain`` in the same module); on a CUDA tensor it launches
its kernel (``apvast_torch/csrc/*.cu``, built at first use) or raises,
and adds one to its ``launches`` count. Inside ``torch.func.vmap`` (the
scene-batched hop) a wrapper on the hop's path calls its op
``apvast_torch::<name>``, whose vmap rule folds the scene axis into the
kernel's leading batch axis (``_batch.py``): one launch for all scenes.
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
from apvast_torch.ops.kernels.tracked_rr import (
    tracked_rr,
    tracked_rr_coords,
    tracked_rr_coords_plain,
    tracked_rr_plain,
)
from apvast_torch.ops.kernels.whiten import (
    blocked_cholesky,
    chol_panel,
    chol_panel_plain,
    chol_tri_inverse,
    chol_tri_inverse_plain,
)

# name -> wrapper: the time-domain hop's in its stage order, then the
# frequency-domain engine's K7, then K11 and K10b, which no engine path calls.
WRAPPERS = {
    "streaming_conv": streaming_conv,
    "rowwise_conv": rowwise_circular_conv,
    "lag_corr": lag_corr,
    "skew_assembly": lag_skew_assemble,
    "statistics": covariance,
    "whiten": chol_panel,
    "subspace": subspace_iterate,
    "tracked_rr": tracked_rr,
    "jacobi_eigh": jacobi_eigh,
    "tracked_rr_coords": tracked_rr_coords,
    "output_filter": circular_filter_overlap,
    "jacobi_eigh_hermitian": jacobi_eigh_hermitian,
    "circular_filter": circular_filter,
    "chol_tri_inverse": chol_tri_inverse,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (name -> launches) to the wrappers' counts: a replayed
    CUDA graph adds the launches its capture counted."""
    for name, n in counts.items():
        WRAPPERS[name].launches += n


__all__ = [
    "WRAPPERS",
    "add_launch_counts",
    "blocked_cholesky",
    "chol_panel",
    "chol_panel_plain",
    "chol_tri_inverse",
    "chol_tri_inverse_plain",
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
    "tracked_rr",
    "tracked_rr_coords",
    "tracked_rr_coords_plain",
    "tracked_rr_plain",
]
