"""K4: the plain version of the port's Jacobi eigensolver against the JAX
Pallas kernel (interpret mode) and against a float64 NumPy oracle.

At the production count of 2 sweeps the result is not a converged
eigendecomposition and depends on the rotation order, so it is compared
element for element with the Pallas kernel on warm-start-like inputs
(a spread diagonal plus a small symmetric perturbation, as the tracking
solver's Rayleigh-Ritz matrices are in steady state). On a cold random
matrix an unconverged sweep can meet a pair with theta ~ 0, where the
angle's sign rule makes float32 rounding choose between two +-45 degree
rotations; there the two implementations (and the Pallas kernel under a
1e-7 input perturbation) part ways, so cold inputs are compared at 8
sweeps, converged, with eigenvector columns up to sign.

Tolerances: float32 rotations with sums taken in another order agree to
1e-5 of the eigenvalue scale (warm, 2 sweeps) and 1e-4 (cold, 8
sweeps: 504 rounds of rounding); the float64 oracle holds the converged
eigenvalues to 2e-4 of their scale and the eigenpair residual to 5e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_torch.ops.kernels.jacobi_eigh import (
    bank_order,
    export_table,
    padded_size,
    pair_table,
    relabeled_pairs,
    tournament_schedule,
)
from apvast_tpu.ops.pallas.jacobi_eigh import jacobi_eigh as jax_jacobi_eigh
from apvast_tpu.ops.pallas.jacobi_eigh import tournament_schedule as jax_schedule
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _warm(rng, b, n):
    """Near-diagonal symmetric matrices with a spread diagonal."""
    e = 1e-2 * rng.standard_normal((b, n, n))
    return (np.linspace(-3.0, 5.0, n) * np.eye(n) + (e + np.swapaxes(e, 1, 2)) / 2).astype(
        np.float32
    )


def _cold(rng, b, n):
    x = rng.standard_normal((b, n, n))
    return ((x + np.swapaxes(x, 1, 2)) / 2).astype(np.float32)


def _sign_aligned(v, ref):
    """v with each column's sign matched to ref's."""
    s = np.sign(np.sum(np.asarray(v, np.float64) * np.asarray(ref, np.float64), axis=-2))
    return np.asarray(v) * s[..., None, :]


@pytest.mark.parametrize("n", [8, 16, 24, 40, 64, 128])
def test_schedule_equals_jax(n):
    np.testing.assert_array_equal(tournament_schedule(n), jax_schedule(n))


@pytest.mark.parametrize("npad", [8, 32, 64, 136])
def test_relabeled_pair_table(npad):
    """The table of K7's in-place rounds: round k pairs the physical slots
    that the moving schedule's pair (2i, 2i+1) occupies, pos_{k+1} =
    pos_k[src]; a sweep meets every index pair exactly once and brings pos
    back to the identity; the packed table carries the slots and, at 64
    slots, a load order whose first (and second) slots of a round lie on 32
    distinct banks."""
    src = tournament_schedule(npad)
    pairs = relabeled_pairs(npad)
    assert pairs.shape == (npad - 1, npad // 2, 2)
    pos = np.arange(npad)
    met = set()
    for k in range(npad - 1):
        np.testing.assert_array_equal(pairs[k], pos.reshape(-1, 2))
        met.update((int(min(p, q)), int(max(p, q))) for p, q in pairs[k])
        pos = pos[src]
    np.testing.assert_array_equal(pos, np.arange(npad))
    assert met == {(p, q) for p in range(npad) for q in range(p + 1, npad)}
    order = bank_order(pairs)
    if npad == 64:
        for k in range(npad - 1):
            first = pairs[k, np.arange(32), order[k]]
            second = pairs[k, np.arange(32), 1 - order[k]]
            assert len(set((first % 32).tolist())) == 32
            assert len(set((second % 32).tolist())) == 32
    else:
        assert not order.any()
    if npad <= 128:
        packed = pair_table(npad, torch.device("cpu")).numpy()
        np.testing.assert_array_equal(packed & 0xFF, pairs[..., 0])
        np.testing.assert_array_equal(packed >> 8 & 0xFF, pairs[..., 1])
        np.testing.assert_array_equal(packed >> 16, order)


@pytest.mark.parametrize("npad", [8, 24, 40, 64])
def test_export_table(npad):
    """The card's pipelined pair-block form: the next round's rotation
    inputs A[P, P], A[Q, Q] and A[P, Q] lie in this round's export blocks
    (bit set), the listed blocks are distinct and off-diagonal, and every
    set bit is a diagonal or a listed block."""
    pairs = relabeled_pairs(npad)
    table = export_table(npad)
    rounds, half, _ = pairs.shape
    words = -(-half * half // 32)
    assert table.shape == (rounds, words + half) and table.dtype == np.int32
    for k in range(rounds):
        owner = {int(s): i for i in range(half) for s in pairs[k, i]}
        bits = (table[k, :words].view(np.uint32)[:, None] >> np.arange(32)) & 1
        marked = set(np.flatnonzero(bits.reshape(-1)).tolist())
        listed = [int(t) for t in table[k, words:] if t >= 0]
        assert len(set(listed)) == len(listed)
        assert all(t // half != t % half for t in listed)
        assert marked == {i * half + i for i in range(half)} | set(listed)
        for p, q in pairs[(k + 1) % rounds]:
            for r, c in ((p, p), (q, q), (p, q)):
                assert owner[int(r)] * half + owner[int(c)] in marked


@pytest.mark.parametrize("n", [64, 22, 10])
def test_plain_matches_pallas_at_two_sweeps(n):
    """The production count on warm-start-like inputs: eigenvalues and
    eigenvectors element for element (n = 22 and 10 pad to 24 and 16)."""
    a = _warm(np.random.default_rng(n), 3, n)
    w, v = K.jacobi_eigh(torch.from_numpy(a), 2)
    jw, jv = jax_jacobi_eigh(jnp.asarray(a), sweeps=2, interpret=True)
    assert w.shape == (3, n) and v.shape == (3, n, n)
    assert _rel(w, jw) <= 1e-5 and _rel(v, jv) <= 1e-5


@pytest.mark.parametrize("n", [64, 22, 10])
def test_plain_matches_pallas_at_eight_sweeps(n):
    a = _cold(np.random.default_rng(100 + n), 3, n)
    w, v = K.jacobi_eigh(torch.from_numpy(a), 8)
    jw, jv = jax_jacobi_eigh(jnp.asarray(a), sweeps=8, interpret=True)
    assert _rel(w, jw) <= 1e-4
    assert _rel(_sign_aligned(v, jv), jv) <= 1e-4


def test_zero_pencils_are_exact():
    """All-zero matrices (the pad pencils of the TPU wrapper's batch
    chunking): every angle is 0 through the 1e-30 guard, so w = 0 and
    v = I exactly, in both implementations."""
    a = np.zeros((4, 10, 10), np.float32)
    w, v = K.jacobi_eigh(torch.from_numpy(a), 2)
    jw, jv = jax_jacobi_eigh(jnp.asarray(a), sweeps=2, interpret=True)
    np.testing.assert_array_equal(w.numpy(), 0.0)
    np.testing.assert_array_equal(v.numpy(), np.broadcast_to(np.eye(10), (4, 10, 10)))
    np.testing.assert_array_equal(np.asarray(jv), v.numpy())


@pytest.mark.parametrize("spectrum", ["random", "clustered"])
def test_eight_sweeps_against_float64_oracle(spectrum):
    rng = np.random.default_rng(7)
    n = 40
    if spectrum == "random":
        a = _cold(rng, 2, n)
    else:
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.concatenate([np.full(8, 5.0), np.full(8, 5.0 + 1e-4), rng.uniform(-1, 1, n - 16)])
        a = ((q * lam) @ q.T).astype(np.float32)[None]
        a = (a + np.swapaxes(a, 1, 2)) / 2
    w, v = (x.numpy().astype(np.float64) for x in K.jacobi_eigh(torch.from_numpy(a), 8))
    w_ref = np.linalg.eigh(a.astype(np.float64))[0]
    assert _rel(w, w_ref) <= 2e-4
    res = a.astype(np.float64) @ v - w[:, None, :] * v
    assert np.abs(res).max() <= 5e-4 * np.abs(w_ref).max()
    gram = np.swapaxes(v, 1, 2) @ v
    assert np.abs(gram - np.eye(n)).max() <= 1e-4


def test_plain_serves_widths_past_128():
    """n = 136 pads to 136 slots, past the card's former shared-memory bound
    of 128: the plain version (the CPU path) serves it, as JAX does, at
    the production count of 2 sweeps on a warm-start-like input.

    Tolerances: 270 rounds of one-ulp differences (fused multiply-adds, the
    rsqrt of the angle) at half the diagonal spacing of n = 64 part the two
    by 8.9e-6 (eigenvalues) and 5.4e-5 (eigenvectors) of scale on this
    input, where the JAX kernel's own result moves by 5.7e-7 and 1.2e-5
    under a 1e-7 relative change of its input: 2e-5 and 1e-4 (the 8-sweep
    tolerance)."""
    a = _warm(np.random.default_rng(136), 1, 136)
    w, v = K.jacobi_eigh(torch.from_numpy(a), 2)
    jw, jv = jax_jacobi_eigh(jnp.asarray(a), sweeps=2, interpret=True)
    assert w.shape == (1, 136) and v.shape == (1, 136, 136)
    assert _rel(w, jw) <= 2e-5 and _rel(v, jv) <= 1e-4


def test_padding_and_input_checks():
    assert [padded_size(n) for n in (1, 8, 10, 37, 64, 65)] == [8, 8, 16, 40, 64, 72]
    with pytest.raises(ValueError, match="square"):
        K.jacobi_eigh(torch.zeros(2, 4, 5), 2)
    with pytest.raises(ValueError, match="float32"):
        K.jacobi_eigh(torch.zeros(2, 4, 4, dtype=torch.float64), 2)
    K.reset_launch_counts()
    K.jacobi_eigh(torch.zeros(2, 4, 4), 2)
    assert K.launch_counts()["jacobi_eigh"] == 0  # a CPU tensor takes the plain version
