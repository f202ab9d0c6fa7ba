"""A cell's inputs: each stream's room impulse responses, fixed by the
configuration, and each stream's two programs, made from ``--seed``.

The responses come from a frozen copy of the port's
``utils/rir.py::correlated_rirs`` (no measured room of this size is
public), scaled and seeded as the configuration says. The programs are made on the
device from a ``torch.Generator`` seeded from ``--seed`` and kept in host
memory, as a sound card's buffers would be; a stream plays its program
cyclically, ``program_hops`` hops long.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of ``seed`` (NumPy's SeedSequence over
    ``seed`` and ``path``)."""
    state = np.random.SeedSequence([int(seed), *path]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def correlated_rirs(
    rir_length: int,
    num_srcs: int,
    num_mics: int,
    seed,
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


def scene_rirs(config: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    """One (zone A, zone B) pair of (rir_length, S, M) float64 responses a
    stream: stream i's from the seeds ``seed_a + step i`` and ``seed_b +
    step i`` of the configuration's ``rirs`` group (stream 0 is the
    port's ``scale_scene``). The rooms are the deployment's and stay fixed
    from run to run; ``--seed`` draws the programs and initial states."""
    sc, rirs = config["scene"], config["rirs"]
    if rirs["generator"] != "correlated":
        raise ValueError(f"unknown RIR generator {rirs['generator']!r}")
    shape = (sc["rir_length"], sc["num_srcs"], sc["num_mics"])
    step = rirs["stream_step"]
    return [
        tuple(rirs["scale"] * correlated_rirs(*shape, seed=rirs[key] + step * i)
              for key in ("seed_a", "seed_b"))
        for i in range(config.get("streams", 1))
    ]


def programs(traffic: dict, seed: int, scenes: int, hop: int, device) -> torch.Tensor:
    """The streams' programs, (scenes, 2, program_hops * hop) float32 in
    host memory (pinned when ``device`` is a card): zero-mean Gaussian
    noise of RMS ``rms``, each stream and zone independent, times the
    mix's level envelope when it has one: the levels ``levels_db`` in
    turn, each held ``level_hops`` hops, the cycle entered at an offset
    drawn from ``seed`` for each stream and zone (every seed plays the same
    levels and steps, at other times)."""
    prog = traffic["program"]
    if prog["kind"] != "gaussian":
        raise ValueError(f"unknown program kind {prog['kind']!r}")
    n = prog["program_hops"] * hop
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    x = torch.randn((scenes, 2, n), generator=gen, device=device, dtype=torch.float32)
    x = x * prog["rms"]
    env = prog.get("envelope")
    if env:
        levels = env["levels_db"]
        per = env["level_hops"] * hop
        cycle = per * len(levels)
        gains = torch.tensor([10.0 ** (db / 20.0) for db in levels], device=device)
        offset = torch.randint(0, cycle, (scenes, 2, 1), generator=gen, device=device)
        x = x * gains[((torch.arange(n, device=device) + offset) // per) % len(levels)]
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=torch.device(device).type == "cuda")
    host.copy_(x)
    return host
