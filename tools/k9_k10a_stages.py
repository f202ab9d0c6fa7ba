"""Time kernels K9 (fused subspace iteration) and K10a (Cholesky panel) on
one CUDA card, split each into its stages, and optionally time an earlier
tree's K9 and K10a beside them, in one process.

    python3 tools/k9_k10a_stages.py [--parent DIR]

Shapes: K9 at the north star of the 'invert' path, a and li (2, 800, 800)
(li lower triangular), q0 (2, 800, 64), 2 iterations; K10a at (2, 128, 128).
Every kernel timed here is first held against its plain version (max
|x - plain| / max |plain| <= 1e-4), and the script stops if one is not.

Times: CUDA-event means with the L2 flushed before every launch, in the
order parent, this tree, this tree, parent.

Stages: each source is built again (into ``apvast_torch/_build/stages/``)
with ``%globaltimer`` stamps that only this build has: thread 0 of block 0
reads the timer at the kernel's start and at the end of every stage, and
each stamp names the kind of the stage it ends. A source that has its own
``STAGE_STAMP(kind)`` hooks is built as it is; one without them (the first
designs) gets them inserted after every grid-wide barrier and
Gram reduction (K9) or between its phases (K10a). Printed per kind, as
means over 50 launches: K9's products (the skinny n x k products with the
Gram partials they write, and the applications of L^-T), Gram reductions,
small factorizations (Cholesky and triangular inverse of the k x k Gram
matrices), and the grid-wide barriers, whose cost is measured by a kernel
of barriers alone at K9's grid and block size and subtracted from the
stages that end in one; K10a's load, factor, inverse and store. Sources
with their own hooks split further: block 0's tile products, and the
shared factorization (csrc/chol_warp.cuh) into its diagonal blocks'
factors, strips with diagonal inverses, trailing updates and merge tree.
The stamped builds are checked against the plain version like the others.

``--parent DIR``: an earlier commit unpacked into a directory that
``.gitignore`` lists, e.g. the tree before the redesign::

    git archive 828cee5 | tar -x -C .archive_check/parent

whose ``csrc/subspace.cu`` and ``csrc/whiten.cu`` are built with the port's
nvcc flags (their C entry points take this tree's arguments; K9's workspace
is sized by the first design's formula, ``PARENT_K9_WORKSPACE``). Prints the
ptxas lines of every build, the card's fp32 rate on one large cuBLAS
product, and the card's name, power limit and clocks.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apvast_torch.ops import kernels as K  # noqa: E402
from apvast_torch.ops.kernels import _build  # noqa: E402
from apvast_torch.ops.kernels import subspace as k9  # noqa: E402

BZ, N, K9_WIDTH, ITERS, PANEL = 2, 800, 64, 2, 128
TOL = 1e-4
LAUNCHES = 50
BARRIER = 16  # added to a stamp's kind when its stage ends at a grid-wide barrier
KINDS = {1: "products", 2: "Gram reductions", 3: "small factorizations", 4: "load",
         5: "factor", 6: "inverse", 7: "store", 8: "tail (write small)",
         9: "diagonal blocks' factors", 10: "strips and diagonal inverses",
         11: "trailing updates", 12: "tile products (block 0's tiles)"}


def PARENT_K9_WORKSPACE(bz: int, n: int, k: int) -> int:  # noqa: N802
    """Floats of the first design's K9 workspace: three (bz, n, k) operands, the
    (bz, ceil(n / 16), k, k) Gram partials and the (bz, k, k) L^-T."""
    return 3 * bz * n * k + bz * -(-n // 16) * k * k + bz * k * k


# Prepended to a source for its stamped build: the stamp buffer, the hook,
# their reader, and a kernel of grid-wide barriers alone.
STAMP_HEADER = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__device__ unsigned long long stage_time[256];
__device__ int stage_kind[256];
__device__ int stage_count;
__device__ int stage_grid[2];
#define STAGE_STAMP(kind)                                                       \
  do {                                                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                                  \
      unsigned long long t_;                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                    \
      const int i_ = stage_count;                                               \
      if (i_ < 256) { stage_time[i_] = t_; stage_kind[i_] = (kind); }           \
      stage_count = i_ + 1;                                                     \
      stage_grid[0] = gridDim.x;                                                \
      stage_grid[1] = blockDim.x;                                               \
    }                                                                           \
  } while (0)
extern "C" int stage_reset() {
  int zero = 0;
  return (int)cudaMemcpyToSymbol(stage_count, &zero, sizeof(int));
}
extern "C" int stage_read(unsigned long long* t, int* kind, int* count, int* grid) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(count, stage_count, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(t, stage_time, 256 * sizeof(long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(kind, stage_kind, 256 * sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(grid, stage_grid, 2 * sizeof(int));
  return (int)e;
}
__global__ void stage_barriers(int n) {
  cooperative_groups::grid_group g = cooperative_groups::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}
extern "C" int stage_barriers_launch(int grid, int threads, int n, cudaStream_t s) {
  void* args[] = {&n};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)stage_barriers, grid, threads, args, 0, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
"""


def _kernel_body(src: str, signature: str) -> tuple[int, int]:
    """(index of the opening brace, index of the closing brace) of the
    function whose definition contains ``signature``."""
    start = src.index("{", src.index(signature))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return start, i
    raise RuntimeError(f"unbalanced braces after {signature!r}")


def _insert_k9_stamps(src: str) -> str:
    """The first design's subspace.cu with a stamp at the kernel's start and end,
    after every grid-wide barrier (a factorization stage if the statement
    before it calls cholqr_factor, else a product stage) and after every
    Gram reduction (reduce_parts)."""
    open_, close = _kernel_body(src, "subspace_kernel(Args p)")
    body = src[open_ + 1:close]
    lines, out = body.split("\n"), []
    for i, line in enumerate(lines):
        out.append(line)
        if "grid.sync();" in line:
            before = next(x for x in reversed(lines[:i]) if x.strip())
            kind = 3 if "cholqr_factor" in before else 1
            out.append(f"STAGE_STAMP({kind} + {BARRIER});")
    body = "\n".join(out)
    src = src[:open_ + 1] + "\nSTAGE_STAMP(0);" + body + "\nSTAGE_STAMP(8);\n" + src[close:]
    src, count = re.subn(r"(reduce_parts\(p, b, [^;]*\);)", r"\1 STAGE_STAMP(2);", src)
    if count != 2:
        raise RuntimeError(f"expected two reduce_parts calls, found {count}")
    return src


def _insert_k10a_stamps(src: str) -> str:
    """The first design's whiten.cu with a stamp at the kernel's start, after the
    load, the column Cholesky, the forward substitution and the store."""
    open_, close = _kernel_body(src, "whiten_kernel(")
    body = src[open_ + 1:close]
    anchors = [("  // Cholesky.", 4), ("  // The right-hand side I", 5)]
    for anchor, kind in anchors:
        if body.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} not found once in whiten.cu")
        body = body.replace(anchor, f"  STAGE_STAMP({kind});\n{anchor}")
    store = body.rindex("  for (int e = tid; e < kP * kP; e += kThreads)")
    body = body[:store] + "  STAGE_STAMP(6);\n" + body[store:]
    return src[:open_ + 1] + "\nSTAGE_STAMP(0);" + body + "\n  STAGE_STAMP(7);\n" + src[close:]


def build(jobs: dict[str, tuple[str, bool]], out_dir: str) -> dict[str, ctypes.CDLL]:
    """name -> (source path, stamped): one nvcc per build, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (path, stamped) in jobs.items():
        with open(path) as f:
            src = f.read()
        if stamped:
            if "STAGE_STAMP(" not in src:
                src = (_insert_k9_stamps(src) if "subspace_kernel" in src
                       else _insert_k10a_stamps(src))
            src = STAMP_HEADER + src
        out = os.path.join(out_dir, name.replace(" ", "_") + ".cu")
        with open(out, "w") as f:
            f.write(src)
        # Headers included by the source resolve against its own csrc.
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", os.path.dirname(path),
               "-o", out[:-3] + ".so", out]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       out[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def _call(fn, argtypes, *args) -> None:
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def k9_launcher(lib: ctypes.CDLL, workspace):
    def run(a, li, q0, iters):
        bz, n, k = q0.shape
        q, small = torch.empty_like(q0), torch.empty((bz, k, k), device=q0.device)
        ws = torch.empty(workspace(bz, n, k), device=q0.device)
        p = ctypes.c_void_p
        _call(lib.subspace_iterate_launch, [p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float],
              a.data_ptr(), li.data_ptr(), q0.data_ptr(), q.data_ptr(), small.data_ptr(),
              ws.data_ptr(), ws.numel(), bz, n, k, iters, 1e-6)
        return q, small
    return run


def k10a_launcher(lib: ctypes.CDLL):
    def run(d):
        l, inv = torch.empty_like(d), torch.empty_like(d)
        p = ctypes.c_void_p
        _call(lib.chol_panel_launch, [p, p, p, ctypes.c_int], d.data_ptr(), l.data_ptr(),
              inv.data_ptr(), d.shape[0])
        return l, inv
    return run


def time_ms(fn, flush: torch.Tensor, iters: int = LAUNCHES) -> float:
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


def check(label: str, got, want) -> None:
    errs = [float((x.double() - w.double()).abs().max() / w.double().abs().max())
            for x, w in zip(got, want)]
    print(f"{label}: against plain {[f'{e:.3e}' for e in errs]}", flush=True)
    if not max(errs) <= TOL:
        raise AssertionError(f"{label}: {max(errs):.3e} > {TOL}")


def stages(label: str, lib: ctypes.CDLL, fn, flush: torch.Tensor) -> dict:
    """Mean time per stage kind (ms) over LAUNCHES stamped launches, the
    count of grid-wide barriers that end a stage of each kind, and the
    launch's grid and block size."""
    t = (ctypes.c_ulonglong * 256)()
    kind = (ctypes.c_int * 256)()
    count, grid = ctypes.c_int(), (ctypes.c_int * 2)()
    totals: dict[int, float] = {}
    barriers: dict[int, int] = {}
    for i in range(LAUNCHES + 3):
        flush.sum()
        lib.stage_reset()
        fn()
        if lib.stage_read(t, kind, ctypes.byref(count), grid):
            raise RuntimeError("stage_read failed")
        if count.value > 256:
            raise RuntimeError(f"{count.value} stamps > 256")
        if i < 3:
            continue
        barriers = {}
        for j in range(1, count.value):
            k = kind[j] % BARRIER
            barriers[k] = barriers.get(k, 0) + (kind[j] >= BARRIER)
            totals[k] = totals.get(k, 0.0) + (t[j] - t[j - 1]) * 1e-6 / LAUNCHES
    print(f"{label} stages (ms, mean of {LAUNCHES}; block 0's stamps, first to last "
          f"{sum(totals.values()):.5f}; grid {grid[0]} x {grid[1]} threads): "
          + ", ".join(f"{KINDS[k]} {v:.5f} ({barriers[k]} ending at a barrier)"
                      for k, v in sorted(totals.items())), flush=True)
    return {"totals": totals, "barriers": barriers, "grid": (grid[0], grid[1])}


def barrier_ms(lib: ctypes.CDLL, grid: tuple[int, int], flush: torch.Tensor) -> float:
    """One grid-wide barrier's cost at ``grid``: (64 barriers - 1) / 63."""
    def run(n):
        _call(lib.stage_barriers_launch, [ctypes.c_int] * 3, grid[0], grid[1], n)
    return (time_ms(lambda: run(64), flush) - time_ms(lambda: run(1), flush)) / 63


def report_k9(label: str, st: dict, per_barrier: float) -> None:
    """K9's stages with each grid-wide barrier's cost taken out of the
    stage it ends, and the barriers on their own line."""
    work = {k: v - st["barriers"][k] * per_barrier for k, v in st["totals"].items()}
    n_bar = sum(st["barriers"].values())
    print(f"{label} split (ms): " + ", ".join(f"{KINDS[k]} {v:.5f}" for k, v in
                                              sorted(work.items()))
          + f", barriers {n_bar} x {per_barrier * 1e3:.3f} us = {n_bar * per_barrier:.5f}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose K9 and K10a to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for name, (secs, log) in _build.build_all(("subspace", "whiten")).items():
        print(f"built {name} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    jobs = {"this k9 stamped": (os.path.join(_build.CSRC, "subspace.cu"), True),
            "this k10a stamped": (os.path.join(_build.CSRC, "whiten.cu"), True)}
    if args.parent:
        csrc = os.path.join(os.path.abspath(args.parent), "apvast_torch", "csrc")
        jobs |= {"parent k9": (os.path.join(csrc, "subspace.cu"), False),
                 "parent k10a": (os.path.join(csrc, "whiten.cu"), False),
                 "parent k9 stamped": (os.path.join(csrc, "subspace.cu"), True),
                 "parent k10a stamped": (os.path.join(csrc, "whiten.cu"), True)}
    libs = build(jobs, os.path.join(_build.BUILD_DIR, "stages"))

    g = torch.Generator().manual_seed(0)

    def spd(b, n):
        x = torch.randn((b, n, n), generator=g)
        return (x @ x.transpose(1, 2) / n + torch.eye(n)).to(dev).contiguous()

    a9 = spd(BZ, N)
    li9 = torch.tril(torch.linalg.inv(torch.linalg.cholesky(spd(BZ, N)))).contiguous()
    q9 = torch.randn((BZ, N, K9_WIDTH), generator=g).to(dev)
    d10 = spd(BZ, PANEL)
    flush = torch.zeros(64 * 2**20 // 4, device=dev)

    this_ws = k9.workspace_floats if hasattr(k9, "workspace_floats") else PARENT_K9_WORKSPACE
    k9_forms = {"this": lambda: K.subspace_iterate(a9, li9, q9, ITERS),
                "this stamped": lambda: k9_launcher(libs["this k9 stamped"], this_ws)(
                    a9, li9, q9, ITERS)}
    k10_forms = {"this": lambda: K.chol_panel(d10),
                 "this stamped": lambda: k10a_launcher(libs["this k10a stamped"])(d10)}
    if args.parent:
        k9_forms |= {name: (lambda lib=libs[f"parent k9{s}"]: k9_launcher(
            lib, PARENT_K9_WORKSPACE)(a9, li9, q9, ITERS))
            for name, s in (("parent", ""), ("parent stamped", " stamped"))}
        k10_forms |= {name: (lambda lib=libs[f"parent k10a{s}"]: k10a_launcher(lib)(d10))
                      for name, s in (("parent", ""), ("parent stamped", " stamped"))}
    want9 = K.subspace_iterate_plain(a9, li9, q9, ITERS)
    want10 = K.chol_panel_plain(d10)
    for name, fn in k9_forms.items():
        check(f"K9 {name}", fn(), want9)
    for name, fn in k10_forms.items():
        check(f"K10a {name}", fn(), want10)

    for label, forms in (("K9 (2, 800, 800) x (2, 800, 64), 2 iterations", k9_forms),
                         ("K10a (2, 128, 128)", k10_forms)):
        order = ["parent", "this", "this", "parent"] if args.parent else ["this", "this"]
        times: dict[str, list[float]] = {}
        for name in order:
            times.setdefault(name, []).append(time_ms(forms[name], flush))
        print(f"{label} ms per call: { {k: [round(t, 5) for t in v] for k, v in times.items()} }",
              flush=True)

    for who in (["parent", "this"] if args.parent else ["this"]):
        st = stages(f"K9 {who}", libs[f"{who} k9 stamped"], k9_forms[f"{who} stamped"], flush)
        per_barrier = barrier_ms(libs[f"{who} k9 stamped"], st["grid"], flush)
        report_k9(f"K9 {who}", st, per_barrier)
        stages(f"K10a {who}", libs[f"{who} k10a stamped"], k10_forms[f"{who} stamped"], flush)
    # The card's fp32 rate on a large cuBLAS product (TF32 off), beside the
    # stage times: what the clock let the SMs do in this call.
    m = torch.randn((4096, 4096), generator=g).to(dev)
    gemm = time_ms(lambda: m @ m, flush, 20)
    print(f"fp32 cuBLAS 4096^3: {gemm:.5f} ms, {2 * 4096**3 / gemm / 1e9:.1f} TFLOP/s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
