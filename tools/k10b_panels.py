"""Time kernel K10b (the port's fused Cholesky and triangular inverse) against
the number of 128-wide panels on one CUDA card.

    python3 tools/k10b_panels.py

For n = 128, 256, ..., 1024 (1 to 8 panels) and a batch of 2 random SPD
matrices: K10b's time, and the two chains that compute the same L^-1,
(a) ``cholesky_ex`` + ``solve_triangular`` and (b) the invert path's
``blocked_cholesky`` (K10a once per panel) + ``triangular_inverse``, each by
CUDA events with the L2 flushed before every launch and the card spinning
while the host enqueues it (the chains, ~10 to ~60 launches each, behind a
spin long enough for all of their host time), so the events time the
device. The step from one panel count to the next is what one more panel
costs. Each kernel result is checked against the plain version first.

``tools/k10b_stages.py`` runs the same sweep with an earlier tree's K10b
beside this one, and splits the kernel into stages by timer stamps. (This
tool once split the first design into phases by ablated builds; those
edits matched that design's source text only, and the stamps replaced
them.) Prints the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apvast_torch.ops import kernels as K  # noqa: E402
from apvast_torch.ops.trisolve import triangular_inverse  # noqa: E402

BATCH = 2
PANEL = 128
TOL = 1e-5  # chip_smoke.py's TOL_CHOL_TRI
SPIN_CYCLES = 200_000  # chip_smoke.py's: ~0.1 ms, covers one wrapper's host path
CHAIN_SPIN_CYCLES = 4_000_000  # ~2 ms: covers a chain's launches


def time_ms(fn, flush: torch.Tensor, iters: int = 20, spin: int = SPIN_CYCLES) -> float:
    """Mean CUDA-event time of ``fn``, the L2 flushed before each launch
    (a 64 MB read) and the card spinning ``spin`` cycles while the host
    enqueues it."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def spd(n: int, g: torch.Generator, dev: torch.device) -> torch.Tensor:
    x = torch.randn((BATCH, n, n), generator=g)
    return (x @ x.transpose(1, 2) / n + torch.eye(n)).to(dev).contiguous()


def sweep(forms: dict, flush: torch.Tensor, panels=range(1, 9)) -> dict:
    """Per panel count: each of ``forms`` (name -> function of b giving
    L^-1), checked against the plain version, then timed with chains (a)
    and (b) in the same loop. Returns {panels: {name: ms}}."""
    dev = flush.device
    g = torch.Generator().manual_seed(0)
    prev, out = {}, {}
    for count in panels:
        n = PANEL * count
        b = spd(n, g, dev)
        want = K.chol_tri_inverse_plain(b)
        for name, fn in forms.items():
            err = float((fn(b) - want).abs().max() / want.abs().max())
            if not err <= TOL:
                raise AssertionError(f"{name} at n={n}: {err:.3e} against plain > {TOL}")
        eye = torch.eye(n, device=dev).expand(BATCH, n, n)
        times = {name: time_ms(lambda fn=fn: fn(b), flush) for name, fn in forms.items()}
        times["chain (a)"] = time_ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(b)[0], eye, upper=False), flush, spin=CHAIN_SPIN_CYCLES)
        times["chain (b)"] = time_ms(lambda: triangular_inverse(K.blocked_cholesky(b)), flush,
                                     spin=CHAIN_SPIN_CYCLES)
        steps = "".join(f", {name} +{ms - prev[name]:.5f}" for name, ms in times.items()
                        if name in prev)
        print(f"({BATCH}, {n}, {n}), {count} panels (ms): "
              + ", ".join(f"{name} {ms:.5f}" for name, ms in times.items())
              + (f"; a panel more:{steps[1:]}" if steps else ""), flush=True)
        prev, out[count] = times, times
    return out


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    flush = torch.zeros(64 * 2**20 // 4, device="cuda")
    sweep({"K10b": K.chol_tri_inverse}, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
