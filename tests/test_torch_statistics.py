"""K6's plain version (``ops/kernels/statistics.py``), the framed
covariance of the dense statistics, against each of the three JAX
variants it replaces, in interpret mode, on the CPU: the resident tile at
tests/test_pallas_statistics.py's (4, 3, 4, 96), J=8; the block-row panels
with nb = 2 and 4; the packed tile pairs at S=3, J=100 under a VMEM budget
that splits them into the most groups. Within 1e-6 of the scale of R,
JAX's own tolerance between its variants (float32 sums in another order),
and within 1e-6 of a float64 oracle. The hop that runs K6 is in
tests/test_torch_dense.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_tpu.ops.pallas.statistics import (
    _covariance_pallas_packed,
    _covariance_pallas_panels,
    covariance_pallas,
)
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _inputs(seed, p, m, s, n, j):
    rng = np.random.default_rng(seed)
    buffers = rng.standard_normal((p, m, s, n)).astype(np.float32)
    targets = rng.standard_normal((2, m, n - j + 1)).astype(np.float32)
    return buffers, targets


def _oracle(buffers, targets, j):
    """R and r_cross of the explicitly built window rows, in float64."""
    p, m, s, n = buffers.shape
    k = n - j + 1
    b64 = buffers.astype(np.float64)
    y = np.stack(
        [b64[..., sv, j - 1 - i : j - 1 - i + k] for sv in range(s) for i in range(j)], axis=2
    )  # (p, m, s*j, k)
    return (np.einsum("pmak,pmbk->pab", y, y),
            np.einsum("pmak,zmk->paz", y, targets.astype(np.float64)))


def _check(buffers, targets, j, want):
    got = K.covariance(torch.from_numpy(buffers), torch.from_numpy(targets), j)
    p, _, s, _ = buffers.shape
    assert got[0].shape == (p, s * j, s * j) and got[1].shape == (p, s * j, 2)
    assert got[0].dtype == torch.float32 and K.covariance.launches == 0
    scale = float(np.abs(np.asarray(want[0])).max())
    for g, w, o in zip(got, want, _oracle(buffers, targets, j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(g.numpy(), o, rtol=0, atol=1e-6 * scale)


def test_plain_equals_resident_tile():
    buffers, targets = _inputs(1, 4, 3, 4, 96, 8)
    _check(buffers, targets, 8,
           covariance_pallas(jnp.asarray(buffers), jnp.asarray(targets), 8, interpret=True))


@pytest.mark.parametrize("nb", [2, 4])
def test_plain_equals_panels(nb):
    buffers, targets = _inputs(2, 4, 3, 4, 96, 8)
    _check(buffers, targets, 8,
           _covariance_pallas_panels(jnp.asarray(buffers), jnp.asarray(targets), 8, True, nb))


def test_plain_equals_packed():
    """SJ = 300: three 128-row tiles, the last zero-padded (as the
    32-speaker scene's SJ = 1600 is), under the tightest budget: the top
    block row alone (the full window fill and its 3 tile pairs), so the
    tile pairs split into the most groups."""
    s, j = 3, 100
    n = 2 * j
    k = n - j + 1
    buffers, targets = _inputs(3, 2, 2, s, n, j)
    budget = 3 * 128 * k * 4 + 3 * 128 * 128 * 4 * 2 + 1
    _check(buffers, targets, j, _covariance_pallas_packed(
        jnp.asarray(buffers), jnp.asarray(targets), j, True, vmem_budget=budget))


def test_input_checks():
    buffers, targets = torch.zeros(4, 2, 3, 40), torch.zeros(2, 2, 33)
    with pytest.raises(ValueError, match="targets shape"):
        K.covariance(buffers, targets, 7)
    with pytest.raises(ValueError, match="frame_length"):
        K.covariance(buffers, targets, 41)
    with pytest.raises(ValueError, match="float32"):
        K.covariance(buffers.double(), targets, 8)
    with pytest.raises(ValueError, match="contiguous"):
        K.covariance(buffers, torch.zeros(2, 2, 40)[..., 7:], 8)
