"""The round-3 subspace GEVD solvers of the port ('invert', 'solve',
'newton' whitening) and K9's plain version against the JAX package.

1. ``subspace_iterate_plain`` against ``subspace_iterate_pallas`` (interpret
   mode): q and the small projection within 1e-5 of scale (both fp32, the
   same algorithm with sums in another order), and against a float64
   oracle: q orthonormal to 1e-5, small = q^T Li A Li^T q to 1e-5.
2. ``jdiag_topk_batched`` for 'invert' and 'solve', both orthonormalizers,
   LAPACK (float64, 1e-9: only rounding separates the packages) and the
   Jacobi kernel's plain version (float32, 1e-4), with K9 and K10a on and
   off. Eigenvector columns are compared after matching their signs:
   Householder QR and LAPACK's eigh choose them.
3. ``jdiag_topk_pencil_batched`` ('newton') in both branches, float64, 1e-9.
4. The hop on the small scene, hop by hop: float64 non-kernel branches of
   all three whitenings free-running over 6 hops (1e-9), and the float32
   configurations with the kernels' plain versions from the JAX state
   carried across before every hop (statistics 1e-4 of scale, target feeds
   1e-4, loudspeaker feeds 5e-2 of signal scale: the GEVD amplifies
   summation-order noise, and 2-3 unconverged Jacobi sweeps decide
   rotations by rounding, see tests/test_torch_tracking.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.engine import SubspaceState, build_plan, hop_statistics, init_state, process_hop
from apvast_torch.ops import kernels as K
from apvast_torch.ops.jdiag import jdiag_topk, jdiag_topk_batched, jdiag_topk_pencil_batched
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_tpu.config import GevdSolver, production_overrides
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from apvast_tpu.ops.jdiag import jdiag_topk as jax_jdiag_topk
from apvast_tpu.ops.jdiag import jdiag_topk_batched as jax_jdiag_topk_batched
from apvast_tpu.ops.jdiag import jdiag_topk_pencil_batched as jax_pencil_batched
from apvast_tpu.ops.lag_statistics import covariance_via_lags_skew
from apvast_tpu.ops.pallas.subspace import subspace_iterate_pallas
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _sign_aligned(v, ref):
    """``v`` with each column's sign matched to ``ref``'s."""
    s = np.sign(np.sum(np.asarray(v, np.float64) * np.asarray(ref, np.float64), axis=-2))
    return np.asarray(v) * np.where(s == 0, 1.0, s)[..., None, :]


def _spd(rng, z, n, dtype):
    x = rng.standard_normal((z, n, n))
    return (x @ x.transpose(0, 2, 1) / n + np.eye(n)).astype(dtype)


def _whitening_inputs(n, k, seed):
    """A pencil batch (2, n, n), its inverse Cholesky factors and a random
    warm start (2, n, k), float32."""
    rng = np.random.default_rng(seed)
    a = _spd(rng, 2, n, np.float64)
    b = _spd(rng, 2, n, np.float64)
    li = np.linalg.inv(np.linalg.cholesky(b))
    q0 = rng.standard_normal((2, n, k))
    return a.astype(np.float32), li.astype(np.float32), q0.astype(np.float32)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("n,k", [(96, 16), (200, 24)])
def test_subspace_iterate_plain_equals_pallas(n, k, iters):
    a, li, q0 = _whitening_inputs(n, k, seed=n + k + iters)
    q, small = (
        x.numpy() for x in K.subspace_iterate(*map(torch.from_numpy, (a, li, q0)), iters)
    )
    jq, jsmall = (
        np.asarray(x)
        for x in subspace_iterate_pallas(*map(jnp.asarray, (a, li, q0)), iters, interpret=True)
    )
    assert q.shape == (2, n, k) and small.shape == (2, k, k)
    assert _rel(q, jq) <= 1e-5
    assert _rel(small, jsmall) <= 1e-5
    q64 = q.astype(np.float64)
    gram = q64.transpose(0, 2, 1) @ q64
    assert np.abs(gram - np.eye(k)).max() <= 1e-5
    li64 = li.astype(np.float64)
    white = li64 @ a.astype(np.float64) @ li64.transpose(0, 2, 1)
    assert _rel(small, q64.transpose(0, 2, 1) @ white @ q64) <= 1e-5


def test_subspace_iterate_zero_iterations_and_checks():
    a, li, q0 = map(torch.from_numpy, _whitening_inputs(32, 8, seed=1))
    q, small = K.subspace_iterate(a, li, q0, 0)
    torch.testing.assert_close(q, q0, rtol=0, atol=0)
    torch.testing.assert_close(small, 0.5 * (small + small.transpose(-1, -2)))
    assert K.launch_counts()["subspace"] == 0  # CPU tensors take the plain version
    with pytest.raises(ValueError, match="multiple of 8"):
        K.subspace_iterate(a, li, q0[..., :6].contiguous(), 1)
    with pytest.raises(ValueError, match="float32"):
        K.subspace_iterate(a.double(), li, q0, 1)
    with pytest.raises(ValueError, match="must be"):
        K.subspace_iterate(a[:, :16, :16].contiguous(), li, q0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.subspace_iterate(a.transpose(-1, -2), li, q0, 1)


_TOPK_CASES = [
    # (dtype, whiten, orth, fused_iteration, whiten_kernel)
    ("float64", "invert", "cholqr2", False, False),
    ("float64", "invert", "qr", False, False),
    ("float64", "solve", "cholqr2", False, False),
    ("float64", "solve", "qr", False, False),
    ("float32", "invert", "cholqr2", False, False),
    ("float32", "invert", "cholqr2", True, True),
    ("float32", "solve", "cholqr2", False, False),
    ("float32", "solve", "qr", False, False),
]


def _pencil_batch(rng, z, n, dtype):
    """Pencils with a decaying spectrum, so the leading Ritz pairs the
    subspace iteration reaches are well separated."""
    q, _ = np.linalg.qr(rng.standard_normal((z, n, n)))
    lam = np.logspace(2, -1, n)
    a = (q * lam[None, None, :]) @ q.transpose(0, 2, 1)
    return a.astype(dtype), _spd(rng, z, n, dtype)


@pytest.mark.parametrize(
    "dtype,whiten,orth,fused,kernel",
    _TOPK_CASES,
    ids=["-".join(str(x) for x in c) for c in _TOPK_CASES],
)
def test_jdiag_topk_batched_equals_jax(dtype, whiten, orth, fused, kernel):
    rng = np.random.default_rng(21)
    n, k, v, iters = 64, 16, 6, 3
    a, b = _pencil_batch(rng, 2, n, dtype)
    q0 = rng.standard_normal((2, n, k)).astype(dtype)
    small_eigh = "lapack" if dtype == "float64" else "jacobi"
    kw = dict(orth=orth, whiten=whiten, small_eigh=small_eigh, jacobi_sweeps=8,
              fused_iteration=fused, whiten_kernel=kernel)
    got = jdiag_topk_batched(*map(torch.from_numpy, (a, b)), 1e-3, v, iters,
                             torch.from_numpy(q0), **kw)
    want = jax_jdiag_topk_batched(*map(jnp.asarray, (a, b)), 1e-3, v, iters,
                                  jnp.asarray(q0), interpret=True, **kw)
    u, d, q, silenced = (x.numpy() for x in got)
    ju, jd, jq, jsilenced = (np.asarray(x) for x in want)
    assert int(silenced) == int(jsilenced) == 0
    assert u.dtype == np.dtype(dtype) and u.shape == (2, n, v) and q.shape == (2, n, k)
    tol = 1e-9 if dtype == "float64" else 1e-4
    assert _rel(d, jd) <= tol
    assert _rel(_sign_aligned(u, ju), ju) <= tol
    assert _rel(_sign_aligned(q, jq), jq) <= tol


def test_jdiag_topk_single_pencil_equals_jax():
    rng = np.random.default_rng(4)
    a, b = _pencil_batch(rng, 1, 40, np.float64)
    q0 = rng.standard_normal((40, 12))
    got = jdiag_topk(torch.from_numpy(a[0]), torch.from_numpy(b[0]), 1e-7, 4, 5,
                     torch.from_numpy(q0), "cholqr2", "invert")
    want = jax_jdiag_topk(jnp.asarray(a[0]), jnp.asarray(b[0]), 1e-7, 4, 5,
                          jnp.asarray(q0), "cholqr2", "invert")
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if g.ndim == 1 else _sign_aligned(g.numpy(), w)
        assert _rel(g, w) <= 1e-9


def test_fused_iteration_requires_invert_and_cholqr2():
    a, b = (torch.eye(16).repeat(2, 1, 1) for _ in range(2))
    q0 = torch.randn(2, 16, 8)
    for kw in (dict(whiten="solve", orth="cholqr2"), dict(whiten="invert", orth="qr")):
        with pytest.raises(ValueError, match="fused_iteration requires"):
            jdiag_topk_batched(a, b, 1e-3, 4, 1, q0, fused_iteration=True, **kw)


@pytest.mark.parametrize("branch", ["rebuild", "newton"])
def test_jdiag_topk_pencil_batched_equals_jax(branch):
    """A cold (identity) carried inverse takes the rebuild branch; one close
    to the loaded dark matrix's inverse takes the Newton step."""
    rng = np.random.default_rng(8)
    n, k, v, reg = 48, 12, 5, 1e-3
    a, b = _pencil_batch(rng, 2, n, np.float64)
    q0 = rng.standard_normal((2, n, k))
    if branch == "rebuild":
        m0 = np.broadcast_to(np.eye(n), (2, n, n)).copy()
    else:
        m0 = np.linalg.inv(b + reg * np.eye(n)) * (1.0 + 1e-2 * rng.standard_normal((2, n, n)))
    got = jdiag_topk_pencil_batched(
        *map(torch.from_numpy, (a, b)), reg, v, 2, torch.from_numpy(q0), torch.from_numpy(m0)
    )
    want = jax_pencil_batched(
        *map(jnp.asarray, (a, b)), reg, v, 2, jnp.asarray(q0), jnp.asarray(m0)
    )
    u, d, q, m, silenced, rebuilt = got
    ju, jd, jq, jm, jsilenced = (np.asarray(x) for x in want)
    assert rebuilt is (branch == "rebuild")
    assert int(silenced) == int(jsilenced) == 0
    assert _rel(d.numpy(), jd) <= 1e-9
    assert _rel(m.numpy(), jm) <= 1e-9
    for g, w in ((u, ju), (q, jq)):
        assert _rel(_sign_aligned(g.numpy(), w), w) <= 1e-9


# ---- the hop ---------------------------------------------------------------


def _arrays(state) -> dict:
    return {
        f.name: None if getattr(state, f.name) is None else np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


class _Pair:
    """One scene, noise, cold basis and hop inputs through both engines."""

    def __init__(self, jc, rir_a, rir_b, seed=3):
        self.jc = jc
        self.tc = config_from_jax(dataclasses.asdict(jc))
        self.rng = np.random.default_rng(seed)
        m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
        noise = (
            1e-3 * self.rng.standard_normal((4, m, s, block)),
            1e-3 * self.rng.standard_normal((2, m, block)),
        )
        self.jplan = jax_build_plan(jc, rir_a, rir_b)
        self.jstate = jax_init_state(jc, response_noise=noise)
        self.plan = build_plan(self.tc, rir_a, rir_b, device="cpu")
        self.state = init_state(
            self.tc, device="cpu", response_noise=noise,
            subspace_init=np.array(self.jstate.gevd_q),
        )
        self._jhop = jax.jit(lambda st, a, b: jax_process_hop(jc, self.jplan, st, a, b))

    def step(self, carry_jax_state):
        dt = np.dtype(self.jc.dtype)
        a, b = ((self.rng.standard_normal(self.jc.hop)).astype(dt) for _ in range(2))
        if carry_jax_state:
            self.state = state_from_numpy(self.tc, _arrays(self.jstate), device="cpu")
        self.jstate, jout = self._jhop(self.jstate, jnp.asarray(a), jnp.asarray(b))
        self.state, out = process_hop(
            self.tc, self.plan, self.state, torch.from_numpy(a), torch.from_numpy(b)
        )
        assert int(out.silenced) == 0 and int(jout.silenced) == 0
        got = [getattr(out, f).numpy() for f in FIELDS]
        want = [np.asarray(getattr(jout, f)) for f in FIELDS]
        return got, want, out.rebuilt


@pytest.mark.parametrize("whiten", ["invert", "solve", "newton"])
def test_hop_float64_parity(small_scene, whiten):
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, gevd_solver=GevdSolver.SUBSPACE, subspace_whiten=whiten)
    pair = _Pair(jc, rir_a, rir_b)
    assert isinstance(pair.state, SubspaceState)
    worst, rebuilds = 0.0, []
    for _ in range(6):
        got, want, rebuilt = pair.step(carry_jax_state=False)
        rebuilds.append(rebuilt)
        worst = max(worst, *(_rel(g, w) for g, w in zip(got, want)))
    assert worst <= 1e-9, f"max relative error vs JAX: {worst:.3e}"
    # The statistics move too much between these short hops for the Newton
    # refresh: every 'newton' hop rebuilds its inverse, like JAX's cond.
    assert rebuilds == [whiten == "newton"] * 6
    if whiten == "newton":
        assert _rel(pair.state.gevd_minv.numpy(), np.asarray(pair.jstate.gevd_minv)) <= 1e-9
    else:
        assert pair.state.gevd_minv is None and pair.jstate.gevd_minv is None


_F32_CONFIGS = {
    "invert-kernels": dict(subspace_whiten="invert", jacobi_sweeps=3,
                           use_pallas_subspace=True, use_pallas_whiten=True),
    "solve": dict(subspace_whiten="solve"),
    "newton": dict(subspace_whiten="newton"),
}


@pytest.mark.parametrize("name", list(_F32_CONFIGS))
def test_hop_float32_from_the_jax_state(small_scene, name):
    """The float32 production values with the round-3 solvers, perceptual
    weighting on, k = V + 10 = 16 (a multiple of 8, for K9)."""
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(
        jc, **(production_overrides("tpu") | dict(perceptual=True, subspace_oversample=10)
               | _F32_CONFIGS[name])
    )
    pair = _Pair(jc, rir_a, rir_b)
    assert pair.tc.subspace_rank == 16
    k = jc.statistics_buffer_length - 1 - jc.filter_length + 1
    for _ in range(6):
        got, want, _ = pair.step(carry_jax_state=True)
        for field, g, w in zip(FIELDS, got, want):
            assert g.dtype == np.float32 and g.shape == w.shape and np.isfinite(g).all()
            assert _rel(g, w) <= (1e-4 if field.endswith("_t") else 5e-2), field
        r_port = hop_statistics(pair.tc, pair.state.wresp_stat, pair.state.wtarget_stat)
        r_jax = covariance_via_lags_skew(
            pair.jstate.wresp_stat, pair.jstate.wtarget_stat[..., -k:], jc.filter_length
        )
        for g, w in zip(r_port, r_jax):
            assert _rel(g.numpy(), w) <= 1e-4


def test_subspace_state_equals_jax(small_scene):
    """A fresh 'newton' state carries the cold basis and an identity
    inverse, an 'invert' one the basis only, as in JAX; both carry across,
    and a leaf of another solver is refused."""
    jc, _, _ = small_scene
    for whiten in ("newton", "invert"):
        jcw = dataclasses.replace(jc, gevd_solver=GevdSolver.SUBSPACE, subspace_whiten=whiten)
        tc = config_from_jax(dataclasses.asdict(jcw))
        want = jax_init_state(jcw)
        got = init_state(tc, device="cpu", subspace_init=np.array(want.gevd_q))
        assert type(got) is SubspaceState
        np.testing.assert_array_equal(got.gevd_q.numpy(), np.asarray(want.gevd_q))
        if whiten == "newton":
            np.testing.assert_array_equal(got.gevd_minv.numpy(), np.asarray(want.gevd_minv))
        else:
            assert got.gevd_minv is None and want.gevd_minv is None
        arrays = _arrays(want)
        carried = state_from_numpy(tc, arrays, device="cpu")
        np.testing.assert_array_equal(carried.gevd_q.numpy(), arrays["gevd_q"])
        with pytest.raises(ValueError, match="gevd_q"):
            state_from_numpy(tc, arrays | {"gevd_q": arrays["gevd_q"][..., 1:]}, device="cpu")
        with pytest.raises(ValueError, match="gevd_lam"):
            state_from_numpy(tc, arrays | {"gevd_lam": np.zeros((2, 3))}, device="cpu")


_REFUSED = {
    "tracking-jacobi": dict(subspace_whiten="tracking", small_eigh="jacobi"),
    "tracking-whiten-kernel": dict(subspace_whiten="tracking", use_pallas_whiten=True),
    "newton-two-flags": dict(subspace_whiten="newton", use_pallas_subspace=True,
                             small_eigh="jacobi"),
    "newton-jacobi": dict(subspace_whiten="newton", small_eigh="jacobi"),
    "solve-jacobi": dict(subspace_whiten="solve", small_eigh="jacobi"),
    "invert-subspace-kernel": dict(subspace_whiten="invert", use_pallas_subspace=True),
    "invert-whiten-kernel": dict(subspace_whiten="invert", use_pallas_whiten=True),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_solver_flag_refusals_equal_jax(small_scene, name):
    """A float32 kernel flag on this float64 scene, or a kernel flag under a
    whitening that does not run its kernel: both engines refuse the hop in
    the same words (with two faults, JAX's order decides which)."""
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, gevd_solver=GevdSolver.SUBSPACE, **_REFUSED[name])
    pair = _Pair(jc, rir_a, rir_b)
    a = np.zeros(jc.hop)
    with pytest.raises(ValueError) as want:
        jax_process_hop(jc, pair.jplan, pair.jstate, jnp.asarray(a), jnp.asarray(a))
    with pytest.raises(ValueError) as got:
        process_hop(pair.tc, pair.plan, pair.state, torch.from_numpy(a), torch.from_numpy(a))
    assert str(got.value) == str(want.value)
