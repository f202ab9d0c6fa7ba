"""Time kernel K7 (the port's Hermitian Jacobi eigensolver) under several
block sizes on one CUDA card, in one process.

    python3 tools/k7_launch_shapes.py

Builds ``apvast_torch/csrc/jacobi_eigh.cu`` once for each value of its
``kHermThreads`` constant (1024 = K4's launch shape, 512, 256) into
``apvast_torch/_build/shapes/``, checks each build's eigenvalues against
the plain version, and times each at the FD engine's shapes,
(1602, 16, 16) and (1602, 32, 32) complex with 6 cold sweeps, by CUDA
events with the L2 flushed before every launch, in the order 1024, 512,
256, 256, 512, 1024. Prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apvast_torch.ops import kernels as K  # noqa: E402
from apvast_torch.ops.kernels import _build  # noqa: E402
from apvast_torch.ops.kernels.jacobi_eigh import padded_size, tournament_schedule  # noqa: E402

SHAPES = (1024, 512, 256)
SWEEPS = 6


def build(out_dir: str) -> dict[int, ctypes.CDLL]:
    with open(os.path.join(_build.CSRC, "jacobi_eigh.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for t in SHAPES:
        path = os.path.join(out_dir, f"jacobi_eigh_{t}.cu")
        with open(path, "w") as f:
            f.write(re.sub(r"constexpr int kHermThreads = \d+;",
                           f"constexpr int kHermThreads = {t};", src))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path]
        procs[t] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for t, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for kHermThreads={t}:\n{log}")
        libs[t] = ctypes.CDLL(os.path.join(out_dir, f"jacobi_eigh_{t}.so"))
    return libs


def launch(lib: ctypes.CDLL, h: torch.Tensor, sweeps: int):
    bz, n, _ = h.shape
    npad = padded_size(2 * n)
    src = torch.as_tensor(tournament_schedule(npad), dtype=torch.int32, device=h.device)
    w = torch.empty((bz, n), device=h.device)
    q = torch.empty((bz, n, n), dtype=torch.complex64, device=h.device)
    fn = lib.jacobi_eigh_hermitian_launch
    # No workspace: these shapes stay within the shared-memory forms.
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(torch.view_as_real(h).data_ptr(), src.data_ptr(), w.data_ptr(),
             torch.view_as_real(q).data_ptr(), None, bz, n, npad, sweeps,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return w, q


def time_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build(os.path.join(_build.BUILD_DIR, "shapes"))
    g = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 * 2**20 // 4, device=dev)
    for n in (16, 32):
        x = torch.complex(torch.randn((1602, n, n), generator=g),
                          torch.randn((1602, n, n), generator=g))
        h = ((x + x.conj().transpose(1, 2)) / 2).to(dev).contiguous()
        wp, _ = K.jacobi_eigh_hermitian_plain(h, SWEEPS)
        for t in SHAPES:
            w, _ = launch(libs[t], h, SWEEPS)
            torch.cuda.synchronize()
            err = float((w - wp).abs().max() / wp.abs().max())
            print(f"(1602, {n}, {n}) kHermThreads={t}: eigenvalues rel_err={err:.3e}", flush=True)
        times: dict[int, list[float]] = {}
        for t in (*SHAPES, *SHAPES[::-1]):
            times.setdefault(t, []).append(time_ms(lambda: launch(libs[t], h, SWEEPS), flush))
        print(f"(1602, {n}, {n}), {SWEEPS} sweeps, ms per launch: "
              f"{ {t: [round(x, 5) for x in v] for t, v in times.items()} }", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
