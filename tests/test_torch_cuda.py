"""The port on a CUDA device: each kernel wrapper against its plain version
at ragged shapes, its launch count, its input checks on the card, and the
slice's hop on the card against the same hop on the CPU.

Needs a card: every test is marked ``cuda`` and skips without one. This
file imports neither JAX nor the shared fixtures, so on a machine without
JAX it runs with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.

Tolerances: kernel and plain version both sum in float32 and may order
the sums differently (1e-4 of the output scale); hop outputs as in
tests/test_torch_hop.py (statistics 1e-4, target feeds 1e-5, loudspeaker
feeds 5e-2 of the signal scale).
"""

import numpy as np
import pytest
import torch

from apvast_torch import ApVast, slice_overrides
from apvast_torch.engine import hop_statistics
from apvast_torch.ops import kernels as K
from apvast_torch.utils.rir import synthetic_rirs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _cases(rnd):
    return {
        "streaming_conv": [
            (rnd(2, 300), rnd(2, 37, 77), 50),
            (rnd(1, 129), rnd(1, 33, 65), 65),
        ],
        "lag_corr": [(rnd(4, 3, 5, 70), 9), (rnd(4, 2, 33, 120), 40), (rnd(2, 1, 1, 10), 1)],
        "skew_assembly": [
            (rnd(4, 45, 6), rnd(4, 6, 45), rnd(4, 5, 45), 9),
            (rnd(2, 33 * 3, 4), rnd(2, 4, 33 * 3), rnd(2, 33, 99), 3),
        ],
        "output_filter": [
            (rnd(2, 100), rnd(2, 37, 9), rnd(100), rnd(2, 37, 70), 30),
            (rnd(2, 100), rnd(2, 37, 9), rnd(100), rnd(2, 37, 40), 60),
            (rnd(1, 50), rnd(1, 17, 50), rnd(50), rnd(1, 17, 0), 50),
        ],
    }


_PLAIN = {
    "streaming_conv": K.streaming_conv_plain,
    "lag_corr": K.lag_corr_plain,
    "skew_assembly": K.lag_skew_assemble_plain,
    "output_filter": K.circular_filter_overlap_plain,
}


@pytest.mark.parametrize("name", list(K.WRAPPERS))
def test_kernel_matches_plain_on_the_card(dev, name):
    g = torch.Generator().manual_seed(7)
    cases = _cases(lambda *s: torch.randn(s, generator=g).to(dev))[name]
    wrapper = K.WRAPPERS[name]
    before = wrapper.launches
    for args in cases:
        got, want = wrapper(*args), _PLAIN[name](*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and a.shape == b.shape
            if b.numel():
                assert _rel(a, b) <= 1e-4
    assert wrapper.launches == before + len(cases)


def test_kernels_refuse_float64_on_the_card(dev):
    x = torch.zeros(4, 2, 3, 30, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        K.lag_corr(x, 5)
    with pytest.raises(ValueError, match="is on"):
        K.streaming_conv(torch.zeros(2, 100, device=dev), torch.zeros(2, 3, 20), 40)


def test_slice_hop_on_the_card_matches_cpu(dev):
    rir_a, rir_b = synthetic_rirs(96, 8, 3, seed=81), synthetic_rirs(96, 8, 3, seed=82)
    rng = np.random.default_rng(9)
    noise = (1e-3 * rng.standard_normal((4, 3, 8, 128)), 1e-3 * rng.standard_normal((2, 3, 128)))
    kwargs = dict(
        block_size=128, rir_a=rir_a, rir_b=rir_b, filter_length=12, modeling_delay=4,
        reference_index_a=0, reference_index_b=5, number_of_eigenvectors=8, mu=1.0,
        statistics_buffer_length=128, sampling_rate=8000, perceptual=True,
        response_noise=noise, **slice_overrides(),
    )
    card, cpu = ApVast(device=dev, **kwargs), ApVast(device="cpu", **kwargs)
    K.reset_launch_counts()
    hops = rng.standard_normal((6, 2, 64)).astype(np.float32)
    got = [card.process_input_buffers(a, b) for a, b in hops]
    assert K.launch_counts() == {name: 6 for name in K.WRAPPERS}
    want = [cpu.process_input_buffers(a, b) for a, b in hops]
    assert int(card.silenced) == 0
    for f in range(4):
        g = torch.stack([x[f] for x in got])
        w = torch.stack([x[f] for x in want])
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= (1e-5 if f >= 2 else 5e-2)
    for a, b in zip(
        hop_statistics(card.config, card.state.wresp_stat, card.state.wtarget_stat),
        hop_statistics(cpu.config, cpu.state.wresp_stat, cpu.state.wtarget_stat),
    ):
        assert _rel(a, b) <= 1e-4
