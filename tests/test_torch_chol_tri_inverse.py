"""K10b's plain version (``ops/kernels/whiten.py::chol_tri_inverse_plain``,
the wrapper's CPU path) against the JAX Pallas kernel
``chol_tri_inverse_pallas`` in interpret mode and against a float64 oracle.

Tolerances. Both sides factor in float32 by the same blocked algorithm with
sums in another order (the JAX kernel solves 32-wide sub-panels below every
panel, the port the 128-wide panel): 2e-5 of scale against JAX and 1e-5
against ``inv(cholesky(B))`` in float64 on well-conditioned matrices, the
JAX package's own bound (``tests/test_whiten_kernel.py``). On the
ill-conditioned matrix (a 1e5 rank-one boost) no float32 factor is within
1e-5 of the oracle; there the whitening residual ``max |X B X^T - I|`` is
held within twice that of the float32 chain ``cholesky`` +
``solve_triangular`` plus 1e-5, as the JAX test holds its kernel. (The
float64 oracle rounded to float32 has a residual of 1e-6 there, below the
7e-4 to 1e-3 of any float32 factorization, so the chain is taken in float32.)

The JAX kernel takes ~6-12 s a call in interpret mode, so the module makes
two calls, in one fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_torch.ops.kernels.whiten import _panel_factor
from apvast_tpu.ops.pallas.whiten import chol_tri_inverse_pallas
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

BAD_PIVOT = 70  # row and column of the negative diagonal entry of the non-PD matrix


def _spd(rng, bz, n, boost=0.0):
    """The JAX tests' SPD batch: a Wishart block plus I, optionally with a
    rank-one boost that makes the first matrix ill-conditioned."""
    a = rng.standard_normal((bz, n, n)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32)
    if boost:
        spd[0] += boost * np.outer(a[0, 0], a[0, 0]) / n
    return spd


def _oracle(b):
    return np.linalg.inv(np.linalg.cholesky(b.astype(np.float64)))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _residual(x, b):
    """max |X B X^T - I| per matrix, in float64."""
    x = np.asarray(x, np.float64)
    eye = np.eye(b.shape[-1])
    return np.abs(x @ b.astype(np.float64) @ x.transpose(0, 2, 1) - eye).max(axis=(1, 2))


@pytest.fixture(scope="module")
def runs():
    """(b, port, jax) at n = 200 (an SPD matrix and a non-PD one: the
    padding path) and n = 256 (the boosted ill-conditioned matrix and a
    well-conditioned one)."""
    out = {}
    b = _spd(np.random.default_rng(1), 2, 200)
    b[1, BAD_PIVOT, BAD_PIVOT] = -1.0
    b256 = _spd(np.random.default_rng(2), 2, 256, boost=1e5)
    for key, x in (("n200", b), ("n256", b256)):
        port = K.chol_tri_inverse(torch.from_numpy(x)).numpy()
        out[key] = (x, port, np.asarray(chol_tri_inverse_pallas(jnp.asarray(x), interpret=True)))
    return out


def test_padded_matches_jax_with_exact_zeros_above(runs):
    b, got, want = runs["n200"]
    assert got.shape == (2, 200, 200) and got.dtype == np.float32
    assert _rel(got[0], _oracle(b[0])) <= 1e-5
    assert np.abs(got[0] - want[0]).max() <= 2e-5 * np.abs(_oracle(b[0])).max()
    assert np.all(np.triu(got, 1) == 0.0)


def test_well_conditioned_matrix_of_the_boosted_batch(runs):
    b, got, want = runs["n256"]
    ref = _oracle(b[1])
    assert _rel(got[1], ref) <= 1e-5
    assert np.abs(got[1] - want[1]).max() <= 2e-5 * np.abs(ref).max()


def test_whitening_residual_ill_conditioned(runs):
    b, got, want = runs["n256"]
    chain = torch.linalg.solve_triangular(
        torch.linalg.cholesky(torch.from_numpy(b)), torch.eye(256).expand(2, 256, 256),
        upper=False,
    ).numpy()
    res, res_chain, res_jax = _residual(got, b), _residual(chain, b), _residual(want, b)
    assert res[0] <= 2.0 * res_chain[0] + 1e-5
    assert res[0] <= 2.0 * res_jax[0] + 1e-5
    assert res[1] <= 1e-5


def test_non_pd_is_non_finite_in_the_entries_jax_gives(runs):
    """A negative pivot overflows the factor (rsqrt(max(p, 1e-30)) = 1e15):
    the rows from the bad pivot's 32-wide sub-panel down are non-finite in
    both, entry for entry in the lower triangle; above the diagonal the
    port keeps exact zeros, where JAX's Neumann-doubled diagonal 32 x 32
    blocks carry NaNs too. The SPD matrix beside it stays finite."""
    _, got, want = runs["n200"]
    lower = np.tril(np.ones((200, 200), bool))
    assert np.isfinite(got[0]).all() and np.isfinite(want[0]).all()
    assert not np.isfinite(got[1]).all()
    np.testing.assert_array_equal(np.isfinite(got[1])[lower], np.isfinite(want[1])[lower])
    first = BAD_PIVOT // 32 * 32
    assert np.isfinite(got[1][:first]).all()
    assert not np.isfinite(got[1][first:][lower[first:]]).any()
    assert np.all(np.triu(got[1], 1) == 0.0)


@pytest.mark.parametrize("bz,n", [(2, 128), (1, 300), (1, 1024)], ids=["n128", "n300", "n1024"])
def test_plain_matches_float64_oracle(bz, n):
    """One panel, a ragged width, and the largest padded size."""
    b = _spd(np.random.default_rng(n), bz, n)
    got = K.chol_tri_inverse(torch.from_numpy(b)).numpy()
    assert _rel(got, _oracle(b)) <= 1e-5
    assert np.all(np.triu(got, 1) == 0.0)


def test_panel_factor_matches_the_column_algorithms():
    """The panel step (32-wide sub-panels, Neumann sub-inverses, merge tree)
    against K10a's plain column Cholesky and substitution inverse."""
    d = torch.from_numpy(_spd(np.random.default_rng(3), 2, 128))
    lp, lpinv = _panel_factor(d)
    l, x = K.chol_panel_plain(d)
    assert _rel(lp, l) <= 1e-5 and _rel(lpinv, x) <= 1e-5
    assert torch.equal(torch.triu(lp, 1), torch.zeros_like(lp))


def test_cpu_call_counts_no_launch():
    b = torch.from_numpy(_spd(np.random.default_rng(4), 2, 40))
    K.reset_launch_counts()
    got = K.chol_tri_inverse(b)
    assert K.launch_counts()["chol_tri_inverse"] == 0
    assert torch.equal(got, K.chol_tri_inverse_plain(b))


@pytest.mark.parametrize(
    "b,match",
    [
        (torch.eye(8, dtype=torch.float64)[None], "float32"),
        (torch.zeros(1, 1025, 1025), "1024"),
        (torch.zeros(2, 8, 7), "square"),
        (torch.zeros(8, 8), "dims"),
        (torch.zeros(2, 8, 8).transpose(-1, -2), "contiguous"),
    ],
    ids=["float64", "npad-past-1024", "non-square", "ndim", "noncontiguous"],
)
def test_refuses_what_the_kernel_does_not_take(b, match):
    with pytest.raises(ValueError, match=match):
        K.chol_tri_inverse(b)
    with pytest.raises(ValueError, match=match):
        K.chol_tri_inverse_plain(b)
