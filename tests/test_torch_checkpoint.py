"""The port's checkpoints and WAV I/O against the JAX package's, on the CPU.

1. Save, load and resume give the same feeds bit for bit, for the exact,
   the tracking and the FD states, through ``process_hop`` and through a
   model's ``state`` setter.
2. The file format is the JAX package's: a checkpoint written by JAX's
   ``save_state`` loads in the port and the port's continuation matches
   JAX's within 1e-9 of scale (float64; only rounding separates the two
   engines), and one written by the port loads in JAX's ``load_state``
   with equal arrays. ``init_shapes`` equals JAX's.
3. The bfloat16 carry (``tracking_li_bf16``) round-trips in the port;
   JAX's own round trip of it raises ``TypeError``.
4. A configuration that does not match the file raises ValueError naming
   the shape.
5. ``load_wav`` and ``save_wav`` equal JAX's on WAV files of every sample
   format, stereo, and with a resample from 44100 to 48000 Hz.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from apvast_torch import ApVast, ApVastFD
from apvast_torch.engine import build_plan, init_fd_state, init_state, process_hop, process_hop_fd
from apvast_torch.engine.fd_hop import FdState
from apvast_torch.engine.state import ApVastState
from apvast_torch.utils import checkpoint as tck
from apvast_torch.utils import io as tio
from apvast_torch.utils.convert import config_from_jax
from apvast_tpu.config import GevdSolver, production_overrides
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine import process_hop as jax_process_hop
from apvast_tpu.engine.fd_hop import FdState as JaxFdState
from apvast_tpu.engine.fd_hop import init_fd_state as jax_init_fd_state
from apvast_tpu.engine.fd_hop import process_hop_fd as jax_process_hop_fd
from apvast_tpu.engine.state import ApVastState as JaxApVastState
from apvast_tpu.utils import checkpoint as jck
from apvast_tpu.utils import io as jio
from apvast_tpu.utils.rir import synthetic_rirs
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("out_a", "out_b", "out_a_t", "out_b_t")
_TRACKING_F64 = dict(gevd_solver=GevdSolver.SUBSPACE, subspace_whiten="tracking",
                     tracking_rebuild_period=3, tracking_warmup_hops=2,
                     tracking_residual_rebuild=2.5)
_FD_F64 = dict(fd_frame_taps=2, num_eigenvectors=4)
# name -> (config overrides, FD engine)
_CONFIGS = {
    "exact": ({}, False),
    "tracking": (_TRACKING_F64, False),
    "fd": (_FD_F64, True),
}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _arrays(state) -> dict:
    return {f.name: None if getattr(state, f.name) is None else np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _config(small_scene, name):
    jc, rir_a, rir_b = small_scene
    overrides, fd = _CONFIGS[name]
    jc = dataclasses.replace(jc, **overrides)
    return jc, config_from_jax(dataclasses.asdict(jc)), rir_a, rir_b, fd


def _hops(rng, hop, n, dtype=np.float64):
    return [tuple(rng.standard_normal(hop).astype(dtype) for _ in range(2)) for _ in range(n)]


def _port_run(tc, plan, state, hops, fd):
    outs = []
    for a, b in hops:
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        if fd:
            state, out = process_hop_fd(tc, plan, state, a, b)
        else:
            state, out = process_hop(tc, plan, state, a, b)
        outs.append([getattr(out, f) for f in FIELDS])
    return state, outs


def _jax_run(jc, jplan, jstate, hops, fd):
    fn = jax.jit(lambda s, a, b: (jax_process_hop_fd if fd else jax_process_hop)(
        jc, jplan, s, a, b))
    outs = []
    for a, b in hops:
        jstate, out = fn(jstate, jnp.asarray(a), jnp.asarray(b))
        outs.append([np.asarray(getattr(out, f)) for f in FIELDS])
    return jstate, outs


def _fresh(tc, fd, noise):
    return init_fd_state(tc, "cpu", response_noise=noise) if fd else init_state(
        tc, "cpu", response_noise=noise)


def _noise(jc, rng):
    m, s, block = jc.num_mics, jc.num_srcs, jc.block_size
    return (1e-3 * rng.standard_normal((4, m, s, block)),
            1e-3 * rng.standard_normal((2, m, block)))


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_resume_is_bit_for_bit(small_scene, name, tmp_path):
    jc, tc, rir_a, rir_b, fd = _config(small_scene, name)
    rng = np.random.default_rng(5)
    plan = build_plan(tc, rir_a, rir_b, "cpu")
    state = _fresh(tc, fd, _noise(jc, rng))
    hops = _hops(rng, tc.hop, 8)
    state, _ = _port_run(tc, plan, state, hops[:4], fd)
    path = tmp_path / "state.npz"
    tck.save_state(str(path), state)
    _, want = _port_run(tc, plan, state, hops[4:], fd)
    loaded = tck.load_state(str(path), tc, FdState if fd else ApVastState, device="cpu")
    assert type(loaded) is type(state)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(loaded, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    _, got = _port_run(tc, plan, loaded, hops[4:], fd)
    for g_hop, w_hop in zip(got, want):
        for g, w in zip(g_hop, w_hop):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, w)


@pytest.mark.parametrize("fd", [False, True], ids=["apvast", "apvast-fd"])
def test_model_resumes_through_its_state_setter(fd, tmp_path):
    """A float32 model (production values; the FD engine with the Jacobi
    kernel's plain version) saved at hop 4 and loaded into a fresh model
    continues hops 5-8 with the same feeds, bit for bit."""
    rir_a, rir_b = synthetic_rirs(120, 4, 3, seed=1), synthetic_rirs(120, 4, 3, seed=2)
    scene = dict(block_size=128, rir_a=rir_a, rir_b=rir_b, filter_length=16, modeling_delay=5,
                 reference_index_a=1, reference_index_b=2, number_of_eigenvectors=4, mu=1.0,
                 sampling_rate=8000, device="cpu")

    def model():
        if fd:
            return ApVastFD(**scene, dtype="float32", use_matmul_dft=True, fd_eigh="jacobi",
                            generator=torch.Generator().manual_seed(3))
        return ApVast(**scene, statistics_buffer_length=160, perceptual=True,
                      generator=torch.Generator().manual_seed(3), **production_overrides())

    rng = np.random.default_rng(6)
    hops = _hops(rng, 64, 8, np.float32)
    first = model()
    for a, b in hops[:4]:
        first.process_input_buffers(a, b)
    path = str(tmp_path / "model.npz")
    tck.save_state(path, first.state)
    want = [first.process_input_buffers(a, b) for a, b in hops[4:]]
    second = model()
    second.state = tck.load_state(path, second.config, FdState if fd else ApVastState,
                                  device="cpu")
    got = [second.process_input_buffers(a, b) for a, b in hops[4:]]
    for g_hop, w_hop in zip(got, want):
        for g, w in zip(g_hop, w_hop):
            assert torch.equal(g, w)
    assert int(second.silenced) == 0


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_jax_checkpoint_resumes_in_the_port(small_scene, name, tmp_path):
    jc, tc, rir_a, rir_b, fd = _config(small_scene, name)
    rng = np.random.default_rng(7)
    jplan = jax_build_plan(jc, rir_a, rir_b)
    jstate = jax_init_fd_state(jc) if fd else jax_init_state(jc, response_noise=_noise(jc, rng))
    hops = _hops(rng, tc.hop, 8)
    jstate, _ = _jax_run(jc, jplan, jstate, hops[:4], fd)
    path = str(tmp_path / "jax.npz")
    jck.save_state(path, jstate)
    _, want = _jax_run(jc, jplan, jstate, hops[4:], fd)
    loaded = tck.load_state(path, tc, FdState if fd else ApVastState, device="cpu")
    _, got = _port_run(tc, build_plan(tc, rir_a, rir_b, "cpu"), loaded, hops[4:], fd)
    worst = 0.0
    for f in range(4):
        g = [hop[f] for hop in got]
        if g[0] is not None:
            worst = max(worst, _rel(torch.stack(g), np.stack([hop[f] for hop in want])))
    assert worst <= 1e-9, worst


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_port_checkpoint_loads_in_jax(small_scene, name, tmp_path):
    jc, tc, rir_a, rir_b, fd = _config(small_scene, name)
    rng = np.random.default_rng(8)
    state = _fresh(tc, fd, _noise(jc, rng))
    state, _ = _port_run(tc, build_plan(tc, rir_a, rir_b, "cpu"), state,
                         _hops(rng, tc.hop, 3), fd)
    path = str(tmp_path / "port.npz")
    tck.save_state(path, state)
    jstate = jck.load_state(path, jc, JaxFdState if fd else JaxApVastState)
    for f in dataclasses.fields(jstate):
        want = getattr(state, f.name, None)
        got = getattr(jstate, f.name)
        if want is None:
            assert got is None, f.name
            continue
        got = np.asarray(got)
        if f.name == "gevd_hop":
            assert got.dtype == np.int32 and int(got) == want == 3
            continue
        want = want.numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    # And the same shapes as JAX's own expectation of the configuration.
    assert tck.init_shapes(tc, FdState if fd else ApVastState) == jck.init_shapes(
        jc, JaxFdState if fd else JaxApVastState)


def test_bf16_carry_round_trips_in_the_port_only(tmp_path):
    """The bfloat16 carry is written as JAX writes it, 2-byte records, and
    read back as bfloat16 by the port; JAX's ``load_state`` raises on its
    own file (``jnp.asarray`` of |V2 records), left as it is."""
    from apvast_tpu.config import ApVastConfig

    jc = ApVastConfig(
        rir_length=64, num_srcs=4, num_mics=8, block_size=64, filter_length=8,
        modeling_delay=3, reference_index_a=0, reference_index_b=1, num_eigenvectors=4,
        mu=1.0, statistics_buffer_length=96, sampling_rate=8000, perceptual=False,
        dtype="float32", gevd_solver=GevdSolver.SUBSPACE, subspace_whiten="tracking",
        tracking_warmup_hops=2, tracking_rebuild_period=3, tracking_li_bf16=True,
    )
    tc = config_from_jax(dataclasses.asdict(jc))
    rir_a, rir_b = synthetic_rirs(64, 4, 8, seed=1), synthetic_rirs(64, 4, 8, seed=2)
    rng = np.random.default_rng(9)
    plan = build_plan(tc, rir_a, rir_b, "cpu")
    state = init_state(tc, "cpu", generator=torch.Generator().manual_seed(0))
    hops = _hops(rng, tc.hop, 8, np.float32)
    state, _ = _port_run(tc, plan, state, hops[:4], False)
    assert state.gevd_minv.dtype == torch.bfloat16
    path = str(tmp_path / "bf16.npz")
    tck.save_state(path, state)
    loaded = tck.load_state(path, tc, device="cpu")
    assert loaded.gevd_minv.dtype == torch.bfloat16
    assert torch.equal(loaded.gevd_minv, state.gevd_minv)
    _, want = _port_run(tc, plan, state, hops[4:], False)
    _, got = _port_run(tc, plan, loaded, hops[4:], False)
    assert all(torch.equal(g, w) for gh, wh in zip(got, want) for g, w in zip(gh, wh))

    # The JAX package on its own state: the file holds the same 2-byte
    # records, which its load_state cannot read back.
    jstate = jax_init_state(jc)
    assert jstate.gevd_minv.dtype == jnp.bfloat16
    jpath = str(tmp_path / "jax_bf16.npz")
    jck.save_state(jpath, jstate)
    with np.load(jpath) as jfile, np.load(path) as tfile:
        assert jfile["gevd_minv"].dtype == tfile["gevd_minv"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jck.load_state(jpath, jc)
    # The port reads the JAX file's carry: the identity it starts from.
    from_jax = tck.load_state(jpath, tc, device="cpu")
    assert from_jax.gevd_minv.dtype == torch.bfloat16
    assert torch.equal(from_jax.gevd_minv.float(), torch.eye(tc.jl).repeat(2, 1, 1))


def test_mismatched_config_raises(small_scene, tmp_path):
    jc, tc, rir_a, rir_b, _ = _config(small_scene, "tracking")
    state = init_state(tc, "cpu")
    path = str(tmp_path / "state.npz")
    tck.save_state(path, state)
    other = dataclasses.replace(tc, filter_length=tc.filter_length + 2)
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, other, device="cpu")
    fd = dataclasses.replace(tc, **_FD_F64)
    tck.save_state(path, init_fd_state(fd, "cpu"))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, dataclasses.replace(fd, num_srcs=3, reference_index_b=1),
                       FdState, device="cpu")


def _write(path, rate, data):
    scipy.io.wavfile.write(str(path), rate, data)
    return str(path)


def test_wav_io_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    x = 0.5 * rng.standard_normal(4410).clip(-1.9, 1.9)
    files = {
        "int16": _write(tmp_path / "i16.wav", 16000, (x * 16000).astype(np.int16)),
        "int32": _write(tmp_path / "i32.wav", 16000, (x * 1e9).astype(np.int32)),
        "uint8": _write(tmp_path / "u8.wav", 8000, (128 + 60 * x).astype(np.uint8)),
        "float32": _write(tmp_path / "f32.wav", 16000, x.astype(np.float32)),
        "stereo": _write(tmp_path / "st.wav", 16000,
                         np.stack([x, -x], axis=1).astype(np.float32)),
        "44100": _write(tmp_path / "r.wav", 44100, (x * 16000).astype(np.int16)),
    }
    for name, path in files.items():
        for target, gain in ((None, 1.0), (48000, 0.5)):
            got, got_rate = tio.load_wav(path, target_rate=target, gain=gain)
            want, want_rate = jio.load_wav(path, target_rate=target, gain=gain)
            assert got_rate == want_rate and got.dtype == want.dtype == np.float64, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert tio.load_wav(files["44100"], 48000)[0].shape == (4800,)
    # save_wav: the same bytes, clipping included.
    y = 1.5 * rng.standard_normal(1000)
    tio.save_wav(str(tmp_path / "port.wav"), y, 48000)
    jio.save_wav(str(tmp_path / "jax.wav"), y, 48000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    rate, data = scipy.io.wavfile.read(str(tmp_path / "port.wav"))
    assert rate == 48000 and data.dtype == np.int16 and data.max() == 32767
