"""Time kernel K7 (the port's Hermitian Jacobi eigensolver) against K4 run on
the real embedding, and optionally against an earlier tree's K7, on one CUDA
card, in one process.

    python3 tools/k7_launch_shapes.py [--parent DIR]

At the FD engine's shapes, (1602, 16, 16) and (1602, 32, 32) complex with 6
cold sweeps (32 and 64 padded slots), it checks and times:

- ``k7``: ``jacobi_eigh_hermitian``, the form this tree ships;
- ``k4-embed``: K4's kernel on ``embed(h)`` and ``select_pairs`` in
  PyTorch, the same rotations through the real kernel;
- ``parent`` (with ``--parent``): the K7 entry of ``DIR``'s
  ``apvast_torch/csrc/jacobi_eigh.cu``, built here with the port's nvcc
  flags. ``DIR`` is an earlier commit unpacked into a directory that
  ``.gitignore`` lists, e.g. the first design of PRs 4-6::

      git archive c6ce357 | tar -x -C .archive_check/parent

  Its entry takes (h, src, w, q, work, bz, n, np, sweeps, stream).

Each form's eigenvalues are held against ``k4-embed``'s (relative error
printed). Times are CUDA-event means with the L2 flushed before every
launch, in the order of the list and then reversed. Prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apvast_torch.ops import kernels as K  # noqa: E402
from apvast_torch.ops.kernels import _build  # noqa: E402
from apvast_torch.ops.kernels.jacobi_eigh import padded_size, schedule, workspace  # noqa: E402
from apvast_torch.ops.kernels.jacobi_eigh_hermitian import embed, select_pairs  # noqa: E402

SWEEPS = 6


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


def parent_k7(parent: str):
    """The K7 entry of ``parent``'s jacobi_eigh.cu, built with the port's
    flags, as a function of (h, sweeps) -> (w, q)."""
    src = os.path.join(parent, "apvast_torch", "csrc", "jacobi_eigh.cu")
    out = os.path.join(parent, "k7_parent.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(out).jacobi_eigh_hermitian_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(h: torch.Tensor, sweeps: int):
        bz, n, _ = h.shape
        npad = padded_size(2 * n)
        work = workspace(bz, npad, h.device)
        w = torch.empty((bz, n), dtype=torch.float32, device=h.device)
        q = torch.empty((bz, n, n), dtype=torch.complex64, device=h.device)
        err = fn(torch.view_as_real(h).data_ptr(), schedule(npad, h.device).data_ptr(),
                 w.data_ptr(), torch.view_as_real(q).data_ptr(),
                 work.data_ptr() if work.numel() else None, bz, n, npad, sweeps,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{src}: jacobi_eigh_hermitian_launch failed: cudaError {err}")
        return w, q

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose K7 to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    parent = parent_k7(args.parent) if args.parent else None
    g = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 * 2**20 // 4, device=dev)
    for n in (16, 32):
        x = torch.complex(torch.randn((1602, n, n), generator=g),
                          torch.randn((1602, n, n), generator=g))
        h = ((x + x.conj().transpose(1, 2)) / 2).to(dev).contiguous()
        forms = {
            "k7": lambda: K.jacobi_eigh_hermitian(h, SWEEPS),
            "k4-embed": lambda: select_pairs(*K.jacobi_eigh(embed(h), SWEEPS), n),
        }
        if parent:
            forms["parent"] = lambda: parent(h, SWEEPS)
        w_ref = forms["k4-embed"]()[0]
        for name, fn in forms.items():
            w = fn()[0]
            torch.cuda.synchronize()
            err = float((w - w_ref).abs().max() / w_ref.abs().max())
            print(f"(1602, {n}, {n}) {name}: eigenvalues against k4-embed rel_err={err:.3e}",
                  flush=True)
        times: dict[str, list[float]] = {}
        for name in (*forms, *reversed(forms)):
            times.setdefault(name, []).append(time_ms(forms[name], flush))
        print(f"(1602, {n}, {n}), {SWEEPS} sweeps, ms per call: "
              f"{ {k: [round(t, 5) for t in v] for k, v in times.items()} }", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
