"""The truncated time-domain perceptual weighting (``weighting_conv_taps``)
against the JAX package, on the CPU.

1. K8's plain version (``ops/kernels/rowwise_conv.py``) against the JAX
   ``rowwise_circular_conv_pallas`` in interpret mode and a float64 NumPy
   oracle, at the JAX test's geometry and a ragged one: with a weighting
   curve's banded k_t to rtol 1e-5 / atol 1e-6, as
   tests/test_weighting_conv.py holds the Pallas kernel (float32 sums in
   another order), and with a general k_t to 1e-5 of the output scale.
2. ``ops/weighting_conv.py``: the Toeplitz shear, both branches of
   ``weighting_kernel`` and the einsum path of ``circular_weighting_conv``
   equal JAX's in float64 to 1e-12 (the same float64 arithmetic).
3. The hop: float64 parity over 6 hops within 1e-9 (matmul DFT on and
   off, the two ``weighting_kernel`` branches); the float32 production
   configuration with the taps against JAX at the tolerances of
   tests/test_torch_hop.py (statistics 1e-4, target feeds 1e-5,
   loudspeaker feeds 5e-2 of signal scale hop by hop from the JAX state,
   as tests/test_torch_tracking.py says why).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.engine import build_plan, hop_statistics, init_state, process_hop
from apvast_torch.ops import kernels as K
from apvast_torch.ops import weighting_conv as tw
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_tpu.config import production_overrides
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from apvast_tpu.ops import weighting_conv as jw
from apvast_tpu.ops.lag_statistics import covariance_via_lags_skew
from apvast_tpu.ops.pallas.rowwise_conv import rowwise_circular_conv_pallas
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rowwise_oracle(x, k_t, taps, b):
    """Each overlap-save frame of the circularly padded rows against its
    zone's k_t, in float64."""
    x, k_t = x.astype(np.float64), k_t.astype(np.float64)
    n, h, u = x.shape[-1], taps // 2, b + taps - 1
    xp = np.concatenate([x[..., n - h :], x, x[..., :h]], axis=-1)
    out = np.zeros(x.shape)
    for f in range(n // b):
        for p in range(4):
            out[p, ..., f * b : (f + 1) * b] = np.einsum(
                "msu,mou->mso", xp[p, ..., f * b : f * b + u], k_t[p % 2]
            )
    return out


@pytest.mark.parametrize(
    "m,s,n,taps,b,banded",
    [(2, 3, 64, 9, 16, True), (3, 5, 90, 11, 30, True), (3, 5, 90, 11, 30, False)],
    ids=["jax-geometry", "ragged", "ragged-general-k_t"],
)
def test_rowwise_conv_plain(m, s, n, taps, b, banded):
    """With the banded k_t of a weighting curve, as the engine builds it,
    at the JAX test's tolerance; with a general k_t (unit-variance entries
    over the whole depth, so sums of B + T - 1 terms of unit scale) to 1e-5
    of the output scale."""
    rng = np.random.default_rng(n + taps)
    x = rng.standard_normal((4, m, s, n)).astype(np.float32)
    if banded:
        w = rng.uniform(0.5, 1.5, (2, m, n // 2 + 1)).astype(np.float32)
        k_t = np.array(jw._banded_toeplitz_t(jw.weighting_kernel(jnp.asarray(w), n, taps), b, taps))
    else:
        k_t = rng.standard_normal((2, m, b, b + taps - 1)).astype(np.float32)
    got = K.rowwise_circular_conv(torch.from_numpy(x), torch.from_numpy(k_t), taps, b)
    assert got.shape == x.shape and got.dtype == torch.float32
    want = rowwise_circular_conv_pallas(jnp.asarray(x), jnp.asarray(k_t), taps, b, interpret=True)
    if banded:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        assert _rel(got, want) <= 1e-5
    assert _rel(got, _rowwise_oracle(x, k_t, taps, b)) <= 1e-5
    assert K.rowwise_circular_conv.launches == 0  # a CPU tensor launches nothing


def test_rowwise_conv_input_checks():
    x, k_t = torch.zeros(4, 2, 3, 64), torch.zeros(2, 2, 16, 24)
    with pytest.raises(ValueError, match="odd"):
        K.rowwise_circular_conv(x, torch.zeros(2, 2, 16, 23), 8, 16)
    with pytest.raises(ValueError, match="divide"):
        K.rowwise_circular_conv(x, k_t, 9, 20)
    with pytest.raises(ValueError, match="k_t shape"):
        K.rowwise_circular_conv(x, k_t, 11, 16)
    with pytest.raises(ValueError, match="float32"):
        K.rowwise_circular_conv(x.double(), k_t, 9, 16)
    with pytest.raises(ValueError, match="4 paths"):
        K.rowwise_circular_conv(x[:2], k_t, 9, 16)


@pytest.mark.parametrize("b,taps", [(16, 9), (40, 17), (3, 1)])
def test_banded_toeplitz_equals_jax(b, taps):
    rng = np.random.default_rng(b)
    kernels = rng.standard_normal((2, 3, taps))
    got = tw._banded_toeplitz_t(torch.from_numpy(kernels), b, taps)
    want = np.asarray(jw._banded_toeplitz_t(jnp.asarray(kernels), b, taps))
    assert got.shape == want.shape == (2, 3, b, b + taps - 1)
    np.testing.assert_array_equal(got.numpy(), want)


def _idft_cos_plain(block):
    ang = 2.0 * np.pi * np.outer(np.arange(block), np.arange(block // 2 + 1)) / block
    inv_w = np.full(block // 2 + 1, 2.0 / block)
    inv_w[0] = inv_w[-1] = 1.0 / block
    return (np.cos(ang) * inv_w).T


@pytest.mark.parametrize("branch", ["irfft", "matmul"])
def test_weighting_kernel_equals_jax(branch):
    rng = np.random.default_rng(4)
    block, taps = 96, 17
    w = rng.uniform(0.5, 1.5, (2, 3, block // 2 + 1))
    idft = _idft_cos_plain(block) if branch == "matmul" else None
    got = tw.weighting_kernel(
        torch.from_numpy(w), block, taps, None if idft is None else torch.from_numpy(idft)
    )
    want = jw.weighting_kernel(jnp.asarray(w), block, taps, None if idft is None else jnp.asarray(idft))
    assert got.shape == (2, 3, taps) and got.dtype == torch.float64
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("block_b", [None, 24, 48])
def test_circular_weighting_conv_equals_jax(block_b):
    rng = np.random.default_rng(9)
    n, taps = 48, 9
    x = rng.standard_normal((4, 2, 3, n))
    kern = jw.weighting_kernel(jnp.asarray(rng.uniform(0.5, 1.5, (2, 2, n // 2 + 1))), n, taps)
    want = jw.circular_weighting_conv(jnp.asarray(x), kern, taps, block_b=block_b)
    got = tw.circular_weighting_conv(
        torch.from_numpy(x), torch.from_numpy(np.array(kern)), taps, block_b=block_b,
        impl="einsum",
    )
    assert _rel(got, want) <= 1e-12
    # "auto" on a CPU tensor takes the einsum path, as JAX does on the CPU.
    auto = tw.circular_weighting_conv(
        torch.from_numpy(x), torch.from_numpy(np.array(kern)), taps, block_b=block_b
    )
    torch.testing.assert_close(auto, got, rtol=0, atol=0)


def test_kernel_path_equals_jax_pallas_float32():
    """impl="pallas" (K8; its plain version for a CPU tensor) against the
    JAX Pallas path in interpret mode, float32, with the circular wrap."""
    rng = np.random.default_rng(21)
    n, taps, b = 64, 9, 16
    x = rng.standard_normal((4, 2, 3, n)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (2, 2, n // 2 + 1)).astype(np.float32)
    kern = jw.weighting_kernel(jnp.asarray(w), n, taps)
    want = jw.circular_weighting_conv(jnp.asarray(x), kern, taps, block_b=b, impl="pallas")
    got = tw.circular_weighting_conv(
        torch.from_numpy(x), torch.from_numpy(np.array(kern)), taps, block_b=b, impl="pallas"
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        tw.circular_weighting_conv(torch.from_numpy(x), torch.from_numpy(np.array(kern)), taps,
                                   impl="fft")


def _arrays(state) -> dict:
    return {
        f.name: None if getattr(state, f.name) is None else np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


class _Pair:
    """One scene, noise (and cold basis) and hop inputs through both engines."""

    def __init__(self, jc, rir_a, rir_b, seed=3, like=None):
        """``like``: a pair of the same config whose jitted JAX hop to
        reuse (one compilation)."""
        self.jc = jc
        self.tc = config_from_jax(dataclasses.asdict(jc))
        self.rng = np.random.default_rng(seed)
        m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
        noise = (
            1e-3 * self.rng.standard_normal((4, m, s, block)),
            1e-3 * self.rng.standard_normal((2, m, block)),
        )
        self.jplan = like.jplan if like else jax_build_plan(jc, rir_a, rir_b)
        self.jstate = jax_init_state(jc, response_noise=noise)
        q0 = None if self.jstate.gevd_q is None else np.array(self.jstate.gevd_q)
        self.plan = build_plan(self.tc, rir_a, rir_b, device="cpu")
        self.state = init_state(self.tc, device="cpu", response_noise=noise, subspace_init=q0)
        self._jhop = like._jhop if like else jax.jit(
            lambda st, a, b: jax_process_hop(jc, self.jplan, st, a, b)
        )

    def inputs(self):
        dt = np.dtype(self.jc.dtype)
        return tuple(self.rng.standard_normal(self.jc.hop).astype(dt) for _ in range(2))

    def step(self, a, b, carry_jax_state=False):
        if carry_jax_state:
            self.state = state_from_numpy(self.tc, _arrays(self.jstate), device="cpu")
        self.jstate, jout = self._jhop(self.jstate, jnp.asarray(a), jnp.asarray(b))
        self.state, out = process_hop(
            self.tc, self.plan, self.state, torch.from_numpy(a), torch.from_numpy(b)
        )
        assert int(out.silenced) == 0 and int(jout.silenced) == 0
        return (
            [getattr(out, f).numpy() for f in FIELDS],
            [np.asarray(getattr(jout, f)) for f in FIELDS],
        )


@pytest.mark.parametrize("matmul_dft", [False, True], ids=["irfft", "matmul-dft"])
def test_weighting_conv_float64_parity(small_scene, matmul_dft):
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, perceptual=True, weighting_conv_taps=9, use_matmul_dft=matmul_dft)
    pair = _Pair(jc, rir_a, rir_b)
    assert pair.tc.weighting_conv_taps == 9
    assert (pair.plan.idft_cos_plain is not None) == matmul_dft
    worst = 0.0
    for _ in range(6):
        got, want = pair.step(*pair.inputs())
        worst = max(worst, *(_rel(g, w) for g, w in zip(got, want)))
    assert worst <= 1e-9, f"max relative error vs JAX: {worst:.3e}"


def test_weighting_conv_production_float32(small_scene):
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(
        jc, **production_overrides("tpu"), perceptual=True, weighting_conv_taps=31
    )
    free = _Pair(jc, rir_a, rir_b)
    forced = _Pair(jc, rir_a, rir_b, like=free)
    k = jc.statistics_buffer_length - 1 - jc.filter_length + 1
    for _ in range(8):
        hops = free.inputs()
        forced.inputs()  # the same draws keep both pairs on one signal
        got, want = free.step(*hops)
        for name, g, w in zip(FIELDS, got, want):
            assert g.dtype == np.float32 and g.shape == w.shape and np.isfinite(g).all()
            if name.endswith("_t"):
                assert _rel(g, w) <= 1e-5, name
        r_port = hop_statistics(free.tc, free.state.wresp_stat, free.state.wtarget_stat)
        r_jax = covariance_via_lags_skew(
            free.jstate.wresp_stat, free.jstate.wtarget_stat[..., -k:], jc.filter_length,
            form="half",
        )
        for g, w in zip(r_port, r_jax):
            assert _rel(g.numpy(), w) <= 1e-4
        got, want = forced.step(*hops, carry_jax_state=True)
        for name, g, w in zip(FIELDS, got, want):
            assert _rel(g, w) <= (1e-5 if name.endswith("_t") else 5e-2), name
