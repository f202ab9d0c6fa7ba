"""Time kernel K10b (the port's fused Cholesky and triangular inverse) against
the number of 128-wide panels on one CUDA card.

    python3 tools/k10b_panels.py

For n = 128, 256, ..., 1024 (1 to 8 panels) and a batch of 2 random SPD
matrices: K10b's time, and the two chains that compute the same L^-1,
(a) ``cholesky_ex`` + ``solve_triangular`` and (b) the invert path's
``blocked_cholesky`` (K10a once per panel) + ``triangular_inverse``, each by
CUDA events with the L2 flushed before every launch. The step from one panel
count to the next is what one more panel costs: its factorization, its
solve and inverse tiles, its trailing update and three grid-wide barriers.
Each result is checked against the plain version first.

Then, at the main path's shape (2, 800, 800), the time that each phase
takes, by ablation: the source is built again (into
``apvast_torch/_build/k10b_ablations/``) with the block-row inverse tiles,
the panel-solve tiles, the trailing update, or all three left out, and each
build is timed beside the full kernel (full, ablations, full). The ablated
builds compute wrong results; they only time what is left. Prints the
card's name and power limit.
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
from apvast_torch.ops.trisolve import triangular_inverse  # noqa: E402

BATCH = 2
PANEL = 128
# name -> (pattern, replacement) edits of csrc/chol_tri_inverse.cu.
ABLATIONS = {
    "no inverse tiles": [(r"per = solves \+ lo / kInvCols", "per = solves")],
    "no solve tiles": [(r"const int solves = \(np - hi\) / kSolveRows", "const int solves = 0")],
    "no trailing update": [(r"share\(a\.bz \* tiles, first, last\)", "share(0, first, last)")],
}
ABLATIONS["factor panels only"] = [e for v in ABLATIONS.values() for e in v]


def build_ablations(out_dir: str) -> dict[str, ctypes.CDLL]:
    with open(os.path.join(_build.CSRC, "chol_tri_inverse.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(ABLATIONS.items()):
        text = src
        for pattern, repl in edits:
            text, count = re.subn(pattern, repl, text)
            if count != 1:
                raise RuntimeError(f"ablation {name!r}: {pattern!r} matched {count} times")
        path = os.path.join(out_dir, f"k10b_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       path[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def launch(lib: ctypes.CDLL, b: torch.Tensor) -> None:
    bz, n, _ = b.shape
    npad = -(-n // PANEL) * PANEL
    out = torch.empty_like(b)
    ws = torch.empty(bz * (2 * npad * npad + PANEL * npad), device=b.device)
    fn = lib.chol_tri_inverse_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(b.data_ptr(), out.data_ptr(), ws.data_ptr(), bz, n, npad,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


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
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    flush = torch.zeros(64 * 2**20 // 4, device=dev)
    prev = None
    for panels in range(1, 9):
        n = 128 * panels
        x = torch.randn((BATCH, n, n), generator=g)
        b = (x @ x.transpose(1, 2) / n + torch.eye(n)).to(dev).contiguous()
        eye = torch.eye(n, device=dev).expand(BATCH, n, n)
        got, want = K.chol_tri_inverse(b), K.chol_tri_inverse_plain(b)
        err = float((got - want).abs().max() / want.abs().max())
        ms = time_ms(lambda: K.chol_tri_inverse(b), flush)
        chain_a = time_ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(b)[0], eye, upper=False), flush)
        chain_b = time_ms(lambda: triangular_inverse(K.blocked_cholesky(b)), flush)
        step = "" if prev is None else f", +{ms - prev:.5f} for the panel"
        prev = ms
        print(f"({BATCH}, {n}, {n}), {panels} panels: K10b {ms:.5f} ms{step}; chain (a) "
              f"{chain_a:.5f}, chain (b) {chain_b:.5f} ms; rel_err against plain {err:.2e}",
              flush=True)
    libs = build_ablations(os.path.join(_build.BUILD_DIR, "k10b_ablations"))
    x = torch.randn((BATCH, 800, 800), generator=g)
    b = (x @ x.transpose(1, 2) / 800 + torch.eye(800)).to(dev).contiguous()
    full = [time_ms(lambda: K.chol_tri_inverse(b), flush)]
    times = {name: time_ms(lambda: launch(lib, b), flush) for name, lib in libs.items()}
    full.append(time_ms(lambda: K.chol_tri_inverse(b), flush))
    print(f"({BATCH}, 800, 800): full kernel {full[0]:.5f} / {full[1]:.5f} ms; "
          + "; ".join(f"{name} {ms:.5f} ms" for name, ms in times.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
