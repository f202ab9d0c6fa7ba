"""K11, the unfused circular filter (``ops/kernels/output_filter.py::
circular_filter``), against the JAX ``circular_filter_pallas`` in interpret
mode and a float64 FFT oracle, on the CPU.

Nothing in either package's engine calls this function; it is ported as
the template form of K5's kernel with the window and the overlap-add
switched off. The cases include a filter as long as the block and a row
count (1000 rows of a 1600-sample block) for which the JAX function pads
its rows to whole 512-row blocks. Tolerance: 1e-5 of the output scale
(float32 FFTs against float32 direct sums; the oracle is float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_tpu.ops.pallas.output_filter import circular_filter_pallas
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _oracle(x, f):
    block = x.shape[-1]
    spec = np.fft.rfft(x.astype(np.float64), axis=-1)[:, None, :]
    return np.fft.irfft(spec * np.fft.rfft(f.astype(np.float64), n=block, axis=-1), n=block,
                        axis=-1)


@pytest.mark.parametrize(
    "z,block,rows,taps",
    [(2, 100, 37, 9), (1, 64, 5, 64), (2, 1600, 1000, 9)],
    ids=["ragged", "taps-equal-block", "jax-pads-rows"],
)
def test_circular_filter_plain(z, block, rows, taps):
    rng = np.random.default_rng(block + rows)
    x = rng.standard_normal((z, block)).astype(np.float32)
    f = rng.standard_normal((z, rows, taps)).astype(np.float32)
    got = K.circular_filter(torch.from_numpy(x), torch.from_numpy(f))
    assert got.shape == (z, rows, block) and got.dtype == torch.float32
    want = circular_filter_pallas(jnp.asarray(x), jnp.asarray(f), interpret=True)
    assert _rel(got, want) <= 1e-5
    assert _rel(got, _oracle(x, f)) <= 1e-5
    assert K.circular_filter.launches == 0  # a CPU tensor launches nothing


def test_circular_filter_is_k5_without_window_and_overlap():
    """With a unit window and a zero tail, K5's emit and new tail are the
    unfused output's two halves."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 96)).astype(np.float32))
    f = torch.from_numpy(rng.standard_normal((2, 7, 11)).astype(np.float32))
    out = K.circular_filter(x, f)
    emit, tail = K.circular_filter_overlap(x, f, torch.ones(96), torch.zeros(2, 7, 48), 48)
    torch.testing.assert_close(torch.cat([emit, tail], -1), out, rtol=1e-5, atol=1e-5)


def test_circular_filter_input_checks():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="does not fit"):
        K.circular_filter(x, torch.zeros(2, 3, 65))
    with pytest.raises(ValueError, match="does not fit"):
        K.circular_filter(x, torch.zeros(1, 3, 5))
    with pytest.raises(ValueError, match="float32"):
        K.circular_filter(x.double(), torch.zeros(2, 3, 5))
    with pytest.raises(ValueError, match="3 dims"):
        K.circular_filter(x, torch.zeros(2, 5))
