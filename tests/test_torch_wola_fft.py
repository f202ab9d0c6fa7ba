"""The port's production WOLA on the FFT against its DFT-matmul form, port
against port on the CPU.

``production_overrides()`` departs from the JAX package's TPU values in
``use_matmul_dft`` alone (False: ``rfft`` / ``irfft``, cuFFT on the card).

1. The production plan builds no DFT matrices.
2. The production hop of each form, 8 hops, one scene (``ApVast``) and
   through ``MultiSceneApVast``'s vmapped hop, each hop from one state:
   the matmul form's, carried into the FFT form before the hop, as the
   card's graphed-against-eager test does. The tracking solver carries its
   basis across hops and amplifies rounding there (free-running, zone B's
   float64 feeds drift from 1.5e-10 to 1.6e-9 of their scale over these 8
   hops, the statistics stay within 1e-14). In float64 (the LAPACK
   eigensolver, the plain output synthesis): every output and the
   statistics within 1e-9 of their scale in each hop. In float32 the
   statistics (R, r), which do not depend on the solver, and the target
   feeds within 1e-5, the loudspeaker feeds within 5e-2 of the largest
   feed sample, the hop tests' tolerances (``tests/test_torch_hop.py``:
   the GEVD of a near-degenerate pencil amplifies rounding). The two forms
   compute the same transforms in another order, so only rounding
   separates them.
3. The fused analysis window (``ops/wola.py::windowed_block``) against
   ``window * cat``, bit for bit, at 50 %, 25 % and 75 % overlap.
"""

import dataclasses

import numpy as np
import pytest
import torch

from apvast_torch import ApVast, ApVastConfig, MultiSceneApVast, production_overrides
from apvast_torch.engine import build_plan, hop_statistics
from apvast_torch.engine.graph import clone_state
from apvast_torch.ops.wola import sine_window, windowed_block
from apvast_torch.utils.rir import synthetic_rirs
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

HOPS = 8
_SCENE = dict(block_size=128, filter_length=16, modeling_delay=5, reference_index_a=1,
              reference_index_b=2, mu=1.0, statistics_buffer_length=160,
              sampling_rate=8000, perceptual=True)
_FLOAT64 = {"dtype": "float64", "small_eigh": "lapack", "statistics_half_form": False,
            "use_pallas_output": False, "use_pallas_conv": False}
_FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def _rirs(i=0):
    return synthetic_rirs(120, 4, 3, seed=2 * i + 1), synthetic_rirs(120, 4, 3, seed=2 * i + 2)


def _models(batched: bool, extra: dict):
    """The FFT form and the matmul form of the production configuration,
    one initial state."""
    models = []
    for matmul in (False, True):
        overrides = production_overrides() | extra | {"use_matmul_dft": matmul}
        if batched:
            pairs = [_rirs(i) for i in range(3)]
            cfg = ApVastConfig.for_rirs(*pairs[0], num_eigenvectors=6, **_SCENE, **overrides)
            gens = [torch.Generator().manual_seed(10 + i) for i in range(3)]
            models.append(MultiSceneApVast(cfg, pairs, device="cpu", generators=gens))
        else:
            models.append(ApVast(rir_a=_rirs()[0], rir_b=_rirs()[1], number_of_eigenvectors=6,
                                 device="cpu", generator=torch.Generator().manual_seed(10),
                                 **_SCENE, **overrides))
    fft, matmul = models
    fft.state = clone_state(matmul.state)
    return fft, matmul


def _statistics(model, batched):
    st, cfg = model.state, model.config
    if not batched:
        return [hop_statistics(cfg, st.wresp_stat, st.wtarget_stat)]
    return [hop_statistics(cfg, st.wresp_stat[i], st.wtarget_stat[i])
            for i in range(st.wresp_stat.shape[0])]


def test_production_plan_builds_no_dft_matrices():
    assert production_overrides()["use_matmul_dft"] is False
    rir_a, rir_b = _rirs()
    cfg = ApVastConfig.for_rirs(rir_a, rir_b, num_eigenvectors=6, **_SCENE,
                                **production_overrides())
    plan = build_plan(cfg, rir_a, rir_b, "cpu")
    for name in ("dft_cos", "dft_sin", "idft_cos", "idft_sin", "idft_cos_plain"):
        assert getattr(plan, name) is None, name
    matmul = build_plan(dataclasses.replace(cfg, use_matmul_dft=True), rir_a, rir_b, "cpu")
    assert tuple(matmul.dft_cos.shape) == (128, 65)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fft_hop_equals_matmul_hop(batched, dtype):
    fft, matmul = _models(batched, _FLOAT64 if dtype == "float64" else {})
    assert not fft.config.use_matmul_dft and fft.plan.dft_cos is None
    rng = np.random.default_rng(7)
    shape = (3, fft.config.hop) if batched else (fft.config.hop,)
    for hop in range(HOPS):
        fft.state = clone_state(matmul.state)
        a, b = (rng.standard_normal(shape).astype(np.dtype(dtype)) for _ in range(2))
        got, want = fft.process_input_buffers(a, b), matmul.process_input_buffers(a, b)
        if batched:
            got, want = ([getattr(out, name) for name in _FIELDS] for out in (got, want))
        for g_stats, w_stats in zip(_statistics(fft, batched), _statistics(matmul, batched)):
            for g, w in zip(g_stats, w_stats):
                assert _rel(g, w) <= (1e-9 if dtype == "float64" else 1e-5), hop
        for f, name in enumerate(_FIELDS):
            g, w = got[f], want[f]
            assert g.dtype == getattr(torch, dtype)
            tol = 1e-9 if dtype == "float64" else (1e-5 if name.endswith("_t") else 5e-2)
            assert torch.isfinite(g).all() and _rel(g, w) <= tol, (hop, name)
    assert fft.rebuilds == matmul.rebuilds
    assert int(fft.silenced.sum()) == 0 and int(matmul.silenced.sum()) == 0


@pytest.mark.parametrize("hop", [8, 4, 12], ids=["50pct", "75pct", "25pct"])
def test_windowed_block_equals_window_times_concatenation(hop):
    """The fused analysis window writes the block that ``window * cat``
    gives, bit for bit, contiguous."""
    block = 16
    g = torch.Generator().manual_seed(hop)
    for dtype in (torch.float32, torch.float64):
        win = sine_window(block, dtype=dtype)
        tail = torch.randn(2, 3, block - hop, generator=g, dtype=dtype)
        fresh = torch.randn(2, 3, hop, generator=g, dtype=dtype)
        got = windowed_block(win, tail, fresh)
        assert got.is_contiguous() and got.dtype == dtype
        assert torch.equal(got, win * torch.cat([tail, fresh], dim=-1))
