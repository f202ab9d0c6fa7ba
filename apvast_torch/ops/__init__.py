"""Tensor operations of the engine (the JAX package's ``ops``); the
hand-written kernels live in ``ops/kernels``. The engine inlines fused
forms of some of these (all four signal paths' statistics, both programs'
streaming convolution); the single-path forms exported here are the
public building blocks."""

from apvast_torch.ops.fir import fir_kernel_spectra, streaming_fir
from apvast_torch.ops.framing import frame_buffer, statistics_matrices
from apvast_torch.ops.jdiag import jdiag, jdiag_batched
from apvast_torch.ops.synthesis import variable_span_filters
from apvast_torch.ops.wola import wola_analyze, wola_overlap_add, wola_overlap_add_tail

__all__ = [
    "fir_kernel_spectra",
    "frame_buffer",
    "jdiag",
    "jdiag_batched",
    "statistics_matrices",
    "streaming_fir",
    "variable_span_filters",
    "wola_analyze",
    "wola_overlap_add",
    "wola_overlap_add_tail",
]
