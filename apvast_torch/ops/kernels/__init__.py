"""Hand-written Hopper kernels of the port, one wrapper module each.

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
    circular_filter_overlap,
    circular_filter_overlap_plain,
)
from apvast_torch.ops.kernels.skew_assembly import (
    lag_skew_assemble,
    lag_skew_assemble_plain,
)
from apvast_torch.ops.kernels.streaming_conv import (
    streaming_conv,
    streaming_conv_plain,
)
from apvast_torch.ops.kernels.subspace import subspace_iterate, subspace_iterate_plain
from apvast_torch.ops.kernels.whiten import blocked_cholesky, chol_panel, chol_panel_plain

# name -> wrapper: the time-domain hop's in its stage order, then the
# frequency-domain engine's K7.
WRAPPERS = {
    "streaming_conv": streaming_conv,
    "lag_corr": lag_corr,
    "skew_assembly": lag_skew_assemble,
    "whiten": chol_panel,
    "subspace": subspace_iterate,
    "jacobi_eigh": jacobi_eigh,
    "output_filter": circular_filter_overlap,
    "jacobi_eigh_hermitian": jacobi_eigh_hermitian,
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
    "circular_filter_overlap",
    "circular_filter_overlap_plain",
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
    "streaming_conv",
    "streaming_conv_plain",
    "subspace_iterate",
    "subspace_iterate_plain",
]
