"""Tensor operations of the engine; the hand-written kernels live in
``ops/kernels``."""
