"""K10a's plain version and the blocked Cholesky of the port
(``ops/kernels/whiten.py``) against the JAX functions, the Pallas panel
kernel run in interpret mode.

Tolerances. The panel factor and its inverse are fp32 column algorithms
on both sides with sums in another order (the Pallas body factors 32-wide
sub-blocks and inverts them by Neumann doubling): 1e-5 of scale on a
well-conditioned panel. The blocked Cholesky is held to JAX's and to a
float64 factor at the JAX package's own tolerances
(``tests/test_whiten_kernel.py``): 5e-5 of scale, and a residual
||L L^T - B|| within 1e-5 of ||B||.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_tpu.ops.pallas.whiten import blocked_cholesky as jax_blocked_cholesky
from apvast_tpu.ops.pallas.whiten import chol_panel_pallas
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _spd(rng, bz, n, boost=0.0):
    """The JAX tests' SPD batch: a Wishart block plus I, optionally with a
    rank-one boost that makes the first matrix ill-conditioned."""
    a = rng.standard_normal((bz, n, n)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32)
    if boost:
        spd[0] += boost * np.outer(a[0, 0], a[0, 0]) / n
    return spd


def test_chol_panel_plain_equals_pallas():
    """Two SPD panels and one with a negative pivot, in one batch: the SPD
    factors and inverses agree, are exactly lower-triangular and satisfy
    their contract; the non-PD panel is non-finite in both."""
    rng = np.random.default_rng(0)
    d = _spd(rng, 3, 128)
    d[2, 40, 40] = -1.0
    jl, jinv = (np.asarray(x) for x in chol_panel_pallas(jnp.asarray(d), interpret=True))
    l, inv = (x.numpy() for x in K.chol_panel(torch.from_numpy(d)))
    assert l.shape == inv.shape == (3, 128, 128)
    for got, want in ((l, jl), (inv, jinv)):
        assert _rel(got[:2], want[:2]) <= 1e-5
        assert np.all(np.triu(got[:2], 1) == 0.0)
    eye = np.eye(128)
    for z in range(2):
        l64 = l[z].astype(np.float64)
        assert np.abs(l64 @ l64.T - d[z]).max() <= 1e-5 * np.abs(d[z]).max()
        assert np.abs(inv[z].astype(np.float64) @ l64 - eye).max() <= 1e-5
    assert not np.isfinite(l[2]).all() and not np.isfinite(inv[2]).all()
    assert not np.isfinite(jl[2]).all() and not np.isfinite(jinv[2]).all()
    assert np.isfinite(l[2][:40]).all()  # the columns before the bad pivot


@pytest.mark.parametrize("n,boost", [(200, 0.0), (256, 1e5)], ids=["n200-padded", "n256-boosted"])
def test_blocked_cholesky_equals_jax(n, boost):
    """The boost makes the first matrix of the batch ill-conditioned; the
    second is the plain Wishart one."""
    rng = np.random.default_rng(5)
    b = _spd(rng, 2, n, boost)
    got = K.blocked_cholesky(torch.from_numpy(b)).numpy()
    want = np.asarray(jax_blocked_cholesky(jnp.asarray(b), interpret=True))
    ref = np.linalg.cholesky(b.astype(np.float64))
    assert got.shape == (2, n, n)
    assert np.all(np.triu(got, 1) == 0.0)
    assert _rel(got, want) <= 5e-5
    assert _rel(got, ref) <= 5e-5
    res = got.astype(np.float64) @ got.transpose(0, 2, 1) - b
    assert np.abs(res).max() / np.abs(b).max() < 1e-5


def test_blocked_cholesky_launches_one_panel_per_128_columns():
    """On the CPU the wrapper runs the plain version and counts nothing;
    the factor of an n = 300 batch (3 panels after padding) is that of
    torch.linalg.cholesky, and a failed panel gives NaNs, not an error."""
    rng = np.random.default_rng(6)
    b = torch.from_numpy(_spd(rng, 2, 300))
    K.reset_launch_counts()
    got = K.blocked_cholesky(b)
    assert K.launch_counts()["whiten"] == 0
    assert _rel(got, torch.linalg.cholesky(b.double())) <= 5e-5
    bad = b.clone()
    bad[1, 200, 200] = -1e3
    out = K.blocked_cholesky(bad)
    assert torch.isfinite(out[0]).all() and not torch.isfinite(out[1]).all()
    with pytest.raises(ValueError, match="float32"):
        K.blocked_cholesky(b.double())


@pytest.mark.parametrize(
    "d",
    [
        torch.zeros(2, 128, 128, dtype=torch.float64),
        torch.zeros(2, 64, 64),
        torch.zeros(128, 128),
        torch.zeros(2, 128, 128).transpose(-1, -2),
    ],
    ids=["float64", "width", "ndim", "noncontiguous"],
)
def test_chol_panel_rejects_what_the_kernel_does_not_take(d):
    with pytest.raises(ValueError):
        K.chol_panel(d)
