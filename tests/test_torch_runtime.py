"""The port's runtime (``apvast_torch/runtime/``) and serving drain, on the
CPU.

1. The port's own copy of the native rings and hop framer, built into
   ``apvast_torch/_build/``: roundtrip, wraparound, overrun and underrun
   counts, threaded single-producer/single-consumer use, awkward chunks
   (the cases of ``tests/test_runtime.py``).
2. ``StreamHost``: end to end, background thread (and ``stop()``'s
   remainder drain), single zone, atomic pair drop, zone validation, and
   the batched drain equal, bit for bit, to the per-hop loop; and
   ``process_hops_span(pcm=False)`` equal, bit for bit, to n calls of
   ``process_input_buffers`` for both engines.
3. Parity with the JAX package: ``process_hops_span`` (``pcm`` False and
   True) and ``StreamHost``'s output rings against the JAX package's, from
   the JAX model's initial state carried across with
   ``apvast_torch/utils/convert.py``. Tolerance: the float32 hop's
   loudspeaker feeds as in ``tests/test_torch_hop.py``, 5e-2 of the feeds'
   scale (measured here: 1.3e-4 at most).
"""

import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest

from apvast_torch import ApVast, ApVastFD, StreamHost
from apvast_torch.runtime import native
from apvast_torch.runtime.native import HopFramer, RingBuffer
from apvast_torch.utils.convert import state_from_numpy
from apvast_torch.utils.rir import synthetic_rirs
from apvast_tpu.models.apvast import ApVast as JaxApVast
from apvast_tpu.runtime.stream_host import StreamHost as JaxStreamHost
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# tests/test_runtime.py's scene: S = 3, M = 2, float32, the exact solver.
_SCENE = dict(block_size=128, filter_length=12, modeling_delay=4, reference_index_a=0,
              reference_index_b=0, number_of_eigenvectors=3, mu=1.0,
              statistics_buffer_length=96, sampling_rate=8000, perceptual=False,
              dtype="float32")


def _rirs(seed_a=41, seed_b=42):
    return synthetic_rirs(60, 3, 2, seed=seed_a), synthetic_rirs(60, 3, 2, seed=seed_b)


def _model(seeds=(41, 42), **overrides):
    rir_a, rir_b = _rirs(*seeds)
    return ApVast(rir_a=rir_a, rir_b=rir_b, device="cpu", **(_SCENE | overrides))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_library_is_built_under_the_port():
    native.load_native()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(os.path.join("apvast_torch", "_build"))


def _roundtrip(rng):
    ring = RingBuffer(64)
    assert ring.capacity == 64
    data = rng.standard_normal(40).astype(np.float32)
    assert ring.write(data) == 40
    np.testing.assert_array_equal(ring.read(40), data)


def _wraparound(rng):
    ring = RingBuffer(32)
    for _ in range(20):  # past the capacity many times
        chunk = rng.standard_normal(13).astype(np.float32)
        assert ring.write(chunk) == 13
        np.testing.assert_array_equal(ring.read(13), chunk)
    assert ring.overruns == 0 and ring.underruns == 0


def _overrun_underrun(rng):
    ring = RingBuffer(16)
    assert ring.write(np.zeros(20, dtype=np.float32)) == 16
    assert ring.overruns == 1
    assert len(ring.read(20)) == 16
    assert ring.underruns == 1


def _threaded_spsc(rng):
    ring = RingBuffer(1 << 12)
    total = 50_000
    src = rng.standard_normal(total).astype(np.float32)
    received = []

    def producer():
        pos = 0
        while pos < total:
            pos += ring.write(src[pos : pos + 512])

    def consumer():
        got = 0
        while got < total:
            chunk = ring.read(min(384, total - got))
            got += len(chunk)
            if len(chunk):
                received.append(chunk)

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    np.testing.assert_array_equal(np.concatenate(received), src)


def _framer_awkward_chunks(rng):
    framer = HopFramer(hop=128, max_backlog_hops=4)
    sig = rng.standard_normal(500).astype(np.float32)
    for start in range(0, 500, 37):
        framer.push(sig[start : start + 37])
    assert framer.ready == 3  # 500 // 128
    hops = [framer.pop() for _ in range(3)]
    np.testing.assert_array_equal(np.concatenate(hops), sig[: 3 * 128])
    assert framer.pop() is None and framer.dropped == 0


def _framer_drops_past_backlog(rng):
    framer = HopFramer(hop=16, max_backlog_hops=1)  # room for 32 samples
    assert framer.push(np.ones(40, dtype=np.float32)) == 32
    assert framer.dropped == 1 and framer.writable == 0 and framer.ready == 2


_NATIVE_CASES = {
    "roundtrip": _roundtrip,
    "wraparound": _wraparound,
    "overrun-underrun": _overrun_underrun,
    "threaded-spsc": _threaded_spsc,
    "framer-awkward-chunks": _framer_awkward_chunks,
    "framer-drops-past-backlog": _framer_drops_past_backlog,
}


@pytest.mark.parametrize("case", list(_NATIVE_CASES))
def test_rings_and_framer(case):
    _NATIVE_CASES[case](np.random.default_rng(1234))


def _end_to_end(rng):
    model = _model()
    host = StreamHost(model, span_index=-1)
    hop = model.config.hop
    sig_a = rng.standard_normal(hop * 5).astype(np.float32)
    sig_b = rng.standard_normal(hop * 5).astype(np.float32)
    for start in range(0, len(sig_a), 256):  # sound-card-sized chunks
        host.push_input(sig_a[start : start + 256], sig_b[start : start + 256])
    assert host.process_pending() == 5 and host.hops_processed == 5
    out = host.pull_output("a", 0, hop * 5)
    assert out.shape == (hop * 5,) and np.isfinite(out).all()
    assert host.dropped_input_hops == 0 and host.dropped_input_chunks == 0


def _background_thread(rng):
    model = _model((43, 44))
    host = StreamHost(model)
    host.start()
    hop = model.config.hop
    for _ in range(4):
        host.push_input(rng.standard_normal(hop).astype(np.float32),
                        rng.standard_normal(hop).astype(np.float32))
    deadline = time.time() + 20
    while host.hops_processed < 4 and time.time() < deadline:
        time.sleep(0.01)
    host.stop()
    assert host.hops_processed == 4


def _stop_drains_the_remainder(rng):
    """A batched thread waits for a full batch; stop() drains the rest."""
    model = _model((43, 44))
    host = StreamHost(model, backlog_hops=8, batch_hops=4)
    hop = model.config.hop
    host.start()
    host.push_input(rng.standard_normal(hop * 6).astype(np.float32),
                    rng.standard_normal(hop * 6).astype(np.float32))
    deadline = time.time() + 20
    while host.hops_processed < 4 and time.time() < deadline:
        time.sleep(0.01)
    host.stop()
    assert host.hops_processed == 6


def _single_zone(rng):
    model = _model((45, 46), run_b=False)
    host = StreamHost(model)
    hop = model.config.hop
    for _ in range(3):
        assert host.push_input(rng.standard_normal(hop).astype(np.float32),
                               rng.standard_normal(hop).astype(np.float32))
    assert host.process_pending() == 3
    assert np.isfinite(host.pull_output("a", 0, hop * 3)).all()
    assert host.pull_output("b", 0, hop).size == 0


def _atomic_drop(rng):
    model = _model((47, 47), number_of_eigenvectors=2)
    host = StreamHost(model, backlog_hops=1)
    chunk = rng.standard_normal(model.config.hop).astype(np.float32)
    for _ in range(10):  # overflow the small backlog
        host.push_input(chunk, chunk)
    assert host.dropped_input_chunks > 0
    assert host.input_a.ready == host.input_b.ready  # the zones stay aligned


def _zone_validation(rng):
    host = StreamHost(_model(), span_index=-1)
    for bad in ("A", "zone_a", ""):
        with pytest.raises(ValueError, match="zone"):
            host.pull_output(bad, 0, 4)


_HOST_CASES = {
    "end-to-end": _end_to_end,
    "background-thread": _background_thread,
    "stop-drains-the-remainder": _stop_drains_the_remainder,
    "single-zone": _single_zone,
    "atomic-drop": _atomic_drop,
    "zone-validation": _zone_validation,
}


@pytest.mark.parametrize("case", list(_HOST_CASES))
def test_stream_host(case):
    _HOST_CASES[case](np.random.default_rng(1234))


def _rings(host, hops):
    hop = host.hop
    return np.stack([[host.pull_output(z, s, hop * hops) for s in range(host.num_srcs)]
                     for z in ("a", "b")])


@pytest.mark.parametrize("span", [-1, 0])
def test_batched_drain_matches_per_hop(span):
    rng = np.random.default_rng(7)
    hop = _model().config.hop
    sig = rng.standard_normal((2, hop * 6)).astype(np.float32)
    outs = {}
    for batch in (1, 4):
        host = StreamHost(_model(), span_index=span, backlog_hops=8, batch_hops=batch)
        host.push_input(*sig)
        assert host.process_pending() == 6
        outs[batch] = _rings(host, 6)
    np.testing.assert_array_equal(outs[4], outs[1])

    class NoWindow:
        config = _model().config

    with pytest.raises(ValueError, match="process_hops_span"):
        StreamHost(NoWindow(), batch_hops=4)


def _fd_model():
    rir_a, rir_b = _rirs()
    kwargs = {k: v for k, v in _SCENE.items() if k != "statistics_buffer_length"}
    return ApVastFD(rir_a=rir_a, rir_b=rir_b, device="cpu", forgetting=0.97,
                    use_matmul_dft=True, fd_eigh="jacobi", **kwargs)


@pytest.mark.parametrize("engine", ["td", "td-run-a-off", "fd"])
def test_process_hops_span_equals_hop_loop(engine):
    build = {"td": _model, "td-run-a-off": lambda: _model(run_a=False), "fd": _fd_model}[engine]
    rng = np.random.default_rng(8)
    drained, stepped = build(), build()
    hop = drained.config.hop
    sig = rng.standard_normal((2, hop * 5)).astype(np.float32)
    fa, fb = drained.process_hops_span(sig[0], sig[1], span_index=1)
    want = [stepped.process_input_buffers(sig[0, i * hop : (i + 1) * hop],
                                          sig[1, i * hop : (i + 1) * hop]) for i in range(5)]
    for got, f in ((fa, 0), (fb, 1)):
        if want[0][f] is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got, np.concatenate([w[f][1].numpy() for w in want]))
    pa, pb = build().process_hops_span(sig[0], sig[1], span_index=1, pcm=True)
    for got, ref in ((pa, fa), (pb, fb)):
        if ref is not None:  # half a step of 32766 over the peak, and float32 rounding
            peak = max(np.abs(x).max() for x in (fa, fb) if x is not None)
            assert np.abs(got - ref).max() <= peak * (0.5 / 32766 + 4 * np.finfo(np.float32).eps)
    with pytest.raises(ValueError, match="whole-hop"):
        build().process_hops_span(sig[0, :-1], sig[1, :-1])


def _jax_and_port(seeds=(41, 42)):
    """A JAX model and a port model in the JAX model's initial state."""
    rir_a, rir_b = _rirs(*seeds)
    jax_model = JaxApVast(rir_a=rir_a, rir_b=rir_b, key=jax.random.key(0), **_SCENE)
    port = ApVast(rir_a=rir_a, rir_b=rir_b, device="cpu", **_SCENE)
    arrays = {f.name: None if getattr(jax_model.state, f.name) is None
              else np.asarray(getattr(jax_model.state, f.name))
              for f in dataclasses.fields(jax_model.state)}
    port.state = state_from_numpy(port.config, arrays, device="cpu")
    return jax_model, port


@pytest.mark.parametrize("pcm", [False, True])
def test_process_hops_span_matches_jax(pcm):
    jax_model, port = _jax_and_port()
    rng = np.random.default_rng(9)
    sig = rng.standard_normal((2, port.config.hop * 6)).astype(np.float32)
    for got, want in zip(port.process_hops_span(*sig, pcm=pcm),
                         jax_model.process_hops_span(*sig, pcm=pcm)):
        assert got.shape == want.shape == (port.config.hop * 6, 3)
        assert _rel(got, want) <= 5e-2


def test_stream_host_matches_jax():
    jax_model, port = _jax_and_port()
    rng = np.random.default_rng(10)
    hop = port.config.hop
    sig = rng.standard_normal((2, hop * 6)).astype(np.float32)
    rings = []
    for host in (StreamHost(port, backlog_hops=8, batch_hops=3),
                 JaxStreamHost(jax_model, backlog_hops=8, batch_hops=3)):
        for start in range(0, hop * 6, 256):
            assert host.push_input(sig[0, start : start + 256], sig[1, start : start + 256])
        assert host.process_pending() == 6 and host.dropped_input_chunks == 0
        rings.append(_rings(host, 6))
    assert rings[0].shape == (2, 3, hop * 6)
    assert _rel(rings[0], rings[1]) <= 5e-2
