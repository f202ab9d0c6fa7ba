"""Room impulse responses: the bundled reference scene and synthetic
generators for scale sweeps (copy of ``apvast_tpu/utils/rir.py``, pure
NumPy, kept here so the port imports nothing of the JAX package).

The reference ships one scene, ``rirs.mat`` with ``rirA``/``rirB`` shaped
(800, 8, 9) = (rir_length, num_srcs, num_mics). Larger scenes are
generated deterministically from a seed.
"""

from __future__ import annotations

import os

import numpy as np


def load_reference_rirs(path: str | None = None):
    """Load the bundled scene from ``path`` (the reference's ``rirs.mat``)
    if given and present, else a matched synthetic scene.

    Returns (rir_a, rir_b) each (800, 8, 9) float64.
    """
    if path is not None and os.path.exists(path):
        import scipy.io

        data = scipy.io.loadmat(path)
        return np.ascontiguousarray(data["rirA"]), np.ascontiguousarray(data["rirB"])
    return (
        synthetic_rirs(800, 8, 9, seed=11),
        synthetic_rirs(800, 8, 9, seed=13),
    )


def from_vast_layout(rirs: np.ndarray) -> np.ndarray:
    """The offline ``vast.m`` RIR layout (mics, rir_length, srcs) as this
    package's (rir_length, srcs, mics)."""
    return np.ascontiguousarray(np.transpose(rirs, (1, 2, 0)))


def synthetic_rirs(
    rir_length: int,
    num_srcs: int,
    num_mics: int,
    seed: int = 0,
    sampling_rate: float = 8000.0,
    rt60: float = 0.25,
    min_delay: int = 8,
) -> np.ndarray:
    """Deterministic noise-tail RIRs, shape (rir_length, srcs, mics)."""
    rng = np.random.default_rng(seed)
    t = np.arange(rir_length) / sampling_rate
    decay = 10.0 ** (-3.0 * t / rt60)  # -60 dB at rt60
    rirs = np.zeros((rir_length, num_srcs, num_mics))
    for s in range(num_srcs):
        for m in range(num_mics):
            delay = int(rng.integers(min_delay, min_delay + rir_length // 16))
            direct_gain = 1.0 / (1.0 + 0.05 * delay)
            tail = rng.standard_normal(rir_length) * decay * 0.3 * direct_gain
            h = np.roll(tail, delay)
            h[:delay] = 0.0
            h[delay] += direct_gain
            rirs[:, s, m] = h
    return rirs


def correlated_rirs(
    rir_length: int,
    num_srcs: int,
    num_mics: int,
    seed: int = 0,
    direct_span: int = 24,
    tail_len: int = 120,
    mic_kernel: int = 8,
    tail_gain: float = 0.4,
    diffuse_db: float = -50.0,
) -> np.ndarray:
    """Spatially-correlated near-anechoic RIRs, (rir_length, srcs, mics):
    per (src, mic) a direct spike at a small random delay plus a
    per-source common early-reflection tail seen through a short per-mic
    kernel, over a weak independent diffuse floor (``diffuse_db``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(tail_len)
    decay = np.exp(-t / (tail_len / 4))
    tails = rng.standard_normal((num_srcs, tail_len)) * decay
    kernels = np.zeros((num_mics, mic_kernel))
    for m in range(num_mics):
        d = int(rng.integers(0, mic_kernel // 2))
        kernels[m, d] = 1.0
        kernels[m] += (
            0.3 * rng.standard_normal(mic_kernel) * np.exp(-t[:mic_kernel] / 3)
        )
    h = np.zeros((rir_length, num_srcs, num_mics))
    for s in range(num_srcs):
        for m in range(num_mics):
            delay = int(rng.integers(4, direct_span))
            g = 1.0 / (1.0 + 0.02 * delay)
            h[delay, s, m] += g
            tail = np.convolve(tails[s], kernels[m])[: rir_length - delay]
            h[delay : delay + len(tail), s, m] += tail_gain * g * tail
    h += (
        10.0 ** (diffuse_db / 20.0)
        * rng.standard_normal(h.shape)
        * np.exp(-np.arange(rir_length) / (rir_length / 6))[:, None, None]
    )
    return h
