"""The hop with the dense framed statistics of kernel K6
(``use_pallas_statistics`` without lag statistics) against the JAX
package, on the CPU (K6's plain version against the JAX kernel is in
tests/test_torch_statistics.py).

1. The hop under ``production_overrides() | {use_lag_statistics: False}``
   (the tracking solver fed the full-form R) in float32, against the JAX
   engine running ``covariance_pallas`` in interpret mode: R and r within
   1e-4 of their scale on a free-running stream, the target feeds within
   1e-5, and the loudspeaker feeds within 5e-2 of signal scale hop by hop
   from the JAX state (tests/test_torch_tracking.py says why).
2. A float64 configuration raises JAX's ValueError word for word.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.engine import build_plan, hop_statistics, init_state, process_hop
from apvast_torch.engine.hop import half_form
from apvast_torch.utils.convert import config_from_jax, state_from_numpy
from apvast_tpu.config import production_overrides
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from apvast_tpu.ops.pallas.statistics import covariance_pallas
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _arrays(state) -> dict:
    return {
        f.name: None if getattr(state, f.name) is None else np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }


class _Pair:
    """One scene, noise, cold basis and hop inputs through both engines."""

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
        self.plan = build_plan(self.tc, rir_a, rir_b, device="cpu")
        self.state = init_state(self.tc, device="cpu", response_noise=noise,
                                subspace_init=np.array(self.jstate.gevd_q))
        self._jhop = like._jhop if like else jax.jit(
            lambda st, a, b: jax_process_hop(jc, self.jplan, st, a, b)
        )

    def inputs(self):
        return tuple(self.rng.standard_normal(self.jc.hop).astype(np.float32) for _ in range(2))

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


def _dense(jc, **extra):
    return dataclasses.replace(
        jc, **(production_overrides("tpu") | {"use_lag_statistics": False}), perceptual=True,
        **extra,
    )


def test_dense_production_float32(small_scene):
    jc, rir_a, rir_b = small_scene
    jc = _dense(jc)
    free = _Pair(jc, rir_a, rir_b)
    forced = _Pair(jc, rir_a, rir_b, like=free)
    assert free.tc.use_pallas_statistics and not half_form(free.tc)
    j = jc.filter_length
    for _ in range(6):
        hops = free.inputs()
        forced.inputs()  # the same draws keep both pairs on one signal
        got, want = free.step(*hops)
        for name, g, w in zip(FIELDS, got, want):
            assert g.dtype == np.float32 and g.shape == w.shape and np.isfinite(g).all()
            if name.endswith("_t"):
                assert _rel(g, w) <= 1e-5, name
        r_port = hop_statistics(free.tc, free.state.wresp_stat, free.state.wtarget_stat)
        buf = free.jstate.wresp_stat  # deleted-form carry under this config
        k = buf.shape[-1] - j + 1
        r_mats, r_cross = covariance_pallas(buf, free.jstate.wtarget_stat[..., -k:], j,
                                            interpret=True)
        r_jax = (r_mats, np.stack([r_cross[0, :, 0], r_cross[3, :, 1]]))
        for g, w in zip(r_port, r_jax):
            assert g.shape == w.shape and _rel(g.numpy(), w) <= 1e-4
        got, want = forced.step(*hops, carry_jax_state=True)
        for name, g, w in zip(FIELDS, got, want):
            assert _rel(g, w) <= (1e-5 if name.endswith("_t") else 5e-2), name


def test_dense_kernel_refuses_float64(small_scene):
    jc, rir_a, rir_b = small_scene
    jc = dataclasses.replace(jc, use_lag_statistics=False, use_pallas_statistics=True)
    hop = np.zeros(jc.hop)
    jplan, jstate = jax_build_plan(jc, rir_a, rir_b), jax_init_state(jc)
    with pytest.raises(ValueError) as jax_err:
        jax_process_hop(jc, jplan, jstate, jnp.asarray(hop), jnp.asarray(hop))
    tc = config_from_jax(dataclasses.asdict(jc))
    plan, state = build_plan(tc, rir_a, rir_b, "cpu"), init_state(tc, "cpu")
    with pytest.raises(ValueError) as torch_err:
        process_hop(tc, plan, state, torch.from_numpy(hop), torch.from_numpy(hop))
    assert str(torch_err.value) == str(jax_err.value) == (
        "use_pallas_statistics requires dtype=float32"
    )
