"""The public building blocks of ``apvast_torch.ops`` and
``apvast_torch.utils`` against the JAX package's and the reference's
definitions, on the same float64 inputs: the framing and its two Toeplitz
variants, one path's statistics (``statistics_matrices``), the
full-buffer overlap-add, the streaming FIR convolution, ``vast.m``'s RIR
layout, the batched exact solver; and the two packages' exports.

The cases mirror ``tests/test_framing.py`` (``:27``, ``:35``, ``:43``),
``tests/test_wola.py`` (``:46``, ``:57``), ``tests/test_fir.py`` (``:18``,
``:41``) and ``tests/test_utils.py`` (``:52``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.signal
import torch

import apvast_torch.ops
import apvast_torch.utils
import apvast_tpu.ops
import apvast_tpu.utils
from apvast_torch.config import ToeplitzVariant
from apvast_torch.ops import (
    fir_kernel_spectra,
    frame_buffer,
    jdiag_batched,
    statistics_matrices,
    streaming_fir,
    wola_overlap_add,
    wola_overlap_add_tail,
)
from apvast_torch.utils import from_vast_layout
from apvast_tpu.config import ToeplitzVariant as JaxToeplitz
from apvast_tpu.ops import jdiag_batched as jax_jdiag_batched
from apvast_tpu.ops import statistics_matrices as jax_statistics_matrices
from apvast_tpu.ops import wola_overlap_add as jax_wola_overlap_add
from apvast_tpu.ops.framing import frame_buffer as jax_frame_buffer
from apvast_tpu.utils import from_vast_layout as jax_from_vast_layout
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _python_y(buf, j):
    """Y as the Python reference builds it (corner override)."""
    return scipy.linalg.toeplitz(np.flipud(buf[:j]), buf[j:])


def _matlab_y(buf, j):
    return scipy.linalg.toeplitz(np.flipud(buf[:j]), buf[j - 1 :])


@pytest.mark.parametrize("variant", list(ToeplitzVariant))
def test_frame_buffer_variants_equal_the_reference_toeplitz(variant, rng):
    n, j = 40, 7
    buf = rng.standard_normal(n)
    frames = frame_buffer(torch.from_numpy(buf), j, variant)
    want_y = (_python_y if variant is ToeplitzVariant.PYTHON else _matlab_y)(buf, j)
    np.testing.assert_allclose(frames.numpy()[:, ::-1].T, want_y)
    want = jax_frame_buffer(jnp.asarray(buf), j, JaxToeplitz(variant.value))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(want))
    # The default is the engine's contiguous framing.
    if variant is ToeplitzVariant.MATLAB:
        np.testing.assert_array_equal(frame_buffer(torch.from_numpy(buf), j).numpy(),
                                      frames.numpy())


def test_statistics_match_reference_accumulation(rng):
    """R = sum_m Y Y^T and r = sum_m Y d[J:] against the reference's loop
    and the JAX package's ``statistics_matrices``."""
    m, s, n, j = 3, 2, 30, 5
    bufs = rng.standard_normal((m, s, n))
    target = rng.standard_normal((m, n))
    frames = frame_buffer(torch.from_numpy(bufs), j, ToeplitzVariant.PYTHON)
    r_mat, r_vec = statistics_matrices(frames, torch.from_numpy(target), j)
    want_r, want_v = np.zeros((s * j, s * j)), np.zeros(s * j)
    for mi in range(m):
        y = np.concatenate([_python_y(bufs[mi, si], j) for si in range(s)], axis=0)
        want_r += y @ y.T
        want_v += y @ target[mi, j:]
    np.testing.assert_allclose(r_mat.numpy(), want_r, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(r_vec.numpy(), want_v, rtol=1e-10, atol=1e-10)
    jr, jv = jax_statistics_matrices(jnp.asarray(frames.numpy()), jnp.asarray(target), j)
    np.testing.assert_allclose(r_mat.numpy(), np.asarray(jr), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r_vec.numpy(), np.asarray(jv), rtol=1e-12, atol=1e-12)
    assert statistics_matrices(frames, None, j)[1] is None


def test_overlap_add_matches_reference_pattern(rng):
    """[old[hop:]; zeros] + new, the first hop emitted, as JAX's."""
    block, hop = 16, 8
    old, new = rng.standard_normal((3, block)), rng.standard_normal((3, block))
    buf, emitted = wola_overlap_add(torch.from_numpy(old), torch.from_numpy(new), hop)
    want = np.concatenate([old[:, hop:], np.zeros((3, hop))], axis=1) + new
    np.testing.assert_array_equal(buf.numpy(), want)
    np.testing.assert_array_equal(emitted.numpy(), want[:, :hop])
    jbuf, _ = jax_wola_overlap_add(jnp.asarray(old), jnp.asarray(new), hop)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


def test_overlap_add_tail_matches_full_buffer():
    """The tail form emits the full-buffer update's samples bit for bit, at
    50% and 75% overlap."""
    rng = np.random.default_rng(17)
    for block, hop in ((16, 8), (16, 4), (12, 6)):
        full, tail = torch.zeros(3, block, dtype=torch.float64), torch.zeros(3, block - hop,
                                                                             dtype=torch.float64)
        for _ in range(5):
            new = torch.from_numpy(rng.standard_normal((3, block)))
            full, emit_full = wola_overlap_add(full, new, hop)
            tail, emit_tail = wola_overlap_add_tail(tail, new, hop)
            assert torch.equal(emit_tail, emit_full)
            assert torch.equal(tail, full[..., hop:])


def _next_pow2(n):
    return 1 << (n - 1).bit_length()


def test_streaming_fir_matches_stateful_lfilter(rng):
    taps, hop, hops = 100, 64, 7
    kernels = rng.standard_normal((3, 5, taps))  # (mics, srcs, taps)
    signal = rng.standard_normal(hop * hops)
    fft_size = _next_pow2(taps + hop - 1)
    kspec = fir_kernel_spectra(torch.from_numpy(kernels), fft_size)
    history = torch.zeros(fft_size - hop, dtype=torch.float64)
    zi = np.zeros((3, 5, taps - 1))
    for h in range(hops):
        chunk = signal[h * hop : (h + 1) * hop]
        history, ours = streaming_fir(history, torch.from_numpy(chunk), kspec)
        for mi in range(3):
            for si in range(5):
                want, zi[mi, si] = scipy.signal.lfilter(kernels[mi, si], 1.0, chunk,
                                                        zi=zi[mi, si])
                np.testing.assert_allclose(ours[mi, si].numpy(), want, rtol=1e-10, atol=1e-12)


def test_streaming_fir_short_kernel_long_history(rng):
    """A history longer than taps - 1 (FFT rounding) changes nothing."""
    taps, hop = 9, 16
    kernel = rng.standard_normal(taps)
    signal = rng.standard_normal(hop * 4)
    fft_size = _next_pow2(taps + hop - 1)
    kspec = fir_kernel_spectra(torch.from_numpy(kernel), fft_size)
    history = torch.zeros(fft_size - hop, dtype=torch.float64)
    got = []
    for h in range(4):
        history, out = streaming_fir(history, torch.from_numpy(signal[h * hop : (h + 1) * hop]),
                                     kspec)
        got.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(got), scipy.signal.lfilter(kernel, 1.0, signal),
                               rtol=1e-10, atol=1e-12)


def test_from_vast_layout(rng):
    g = rng.standard_normal((3, 40, 2))  # (mics, rir_length, srcs)
    out = from_vast_layout(g)
    assert out.shape == (40, 2, 3) and out.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(out[:, 1, 2], g[2, :, 1])
    np.testing.assert_array_equal(out, jax_from_vast_layout(g))


def test_jdiag_batched_matches_jax(rng):
    """Both zones' exact GEVD in one call: U^T A U = diag(d) descending,
    U^T (B + reg I) U = I, against the JAX package's ``jdiag_batched``."""
    z, n = 2, 6
    x, y = rng.standard_normal((z, n, 2 * n)), rng.standard_normal((z, n, 2 * n))
    a, b = x @ x.transpose(0, 2, 1), y @ y.transpose(0, 2, 1)
    u, d = jdiag_batched(torch.from_numpy(a), torch.from_numpy(b), 1e-7)
    ju, jd = jax_jdiag_batched(jnp.asarray(a), jnp.asarray(b), 1e-7)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-10)
    # Eigenvectors up to sign.
    signs = np.sign(np.sum(u.numpy() * np.asarray(ju), axis=-2, keepdims=True))
    np.testing.assert_allclose(u.numpy() * signs, np.asarray(ju), rtol=1e-8, atol=1e-10)
    eye = np.eye(n)
    ut = u.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(ut @ (b + 1e-7 * eye) @ u.numpy(), np.broadcast_to(eye, b.shape),
                               atol=1e-9)
    assert np.all(np.diff(d.numpy(), axis=-1) <= 0)
    with pytest.raises(ValueError, match="stacks"):
        jdiag_batched(torch.from_numpy(a[0]), torch.from_numpy(b[0]))


def test_exports_equal_jax():
    assert sorted(apvast_torch.ops.__all__) == sorted(apvast_tpu.ops.__all__)
    assert sorted(apvast_torch.utils.__all__) == sorted(apvast_tpu.utils.__all__)
    for module in (apvast_torch.ops, apvast_torch.utils):
        assert all(callable(getattr(module, name)) for name in module.__all__)
