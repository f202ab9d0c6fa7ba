"""Time kernel K10b (fused Cholesky and triangular inverse) on one CUDA card,
split it into its stages, and optionally time an earlier tree's K10b beside
it, in one process.

    python3 tools/k10b_stages.py [--parent DIR] [--first-only] [--no-sweep]

Shapes: (2, 800, 800), which pads to 896 (7 panels), the shape
``chip_smoke.py`` times, and (1, 1024, 1024) (8 panels). Every kernel
timed here is first held against its plain version (max |x - plain| /
max |plain| <= 1e-5, ``chip_smoke.py``'s ``TOL_CHOL_TRI``), and the script
stops if one is not.

Times: CUDA-event means over 50 launches, the L2 flushed before every
launch (a 64 MB read) and the card spinning ~0.1 ms while the host
enqueues it (``tools/k3_k5_stages.py``), in the order parent, this tree,
this tree, parent; then ``tools/k10b_panels.py``'s sweep over 1 to 8
panels with both trees' K10b beside chains (a) and (b) (``--no-sweep``
skips it).

Stages: each source is built again (into ``apvast_torch/_build/stages/``)
with ``%globaltimer`` stamps that only this build has (the stamp header of
``tools/k2_k4_stages.py``, and ``STAGE_ANY`` below). Thread 0 of block 0,
which factors matrix 0's panels in both designs, stamps the end of each
stage it runs: the panel factorization F split into its warp factors,
Neumann-doubled sub-inverses, strip solves, in-panel updates, merge tree
and its load and store, and its waits (grid barriers in the first
design, ready counters in the redesign); its stamps, first to last, are
the critical path. Thread 0 of every block adds the time it spends in
each kind of tile (solve, update, inverse) and waiting into per-kind sums
(``STAGE_ANY``): their total over the grid is the sum of the stages, the
work beside the critical path; the SM clock cycles (``clock64``) over the
same intervals give the SM's clock during the launch. A source with its
own ``STAGE_STAMP`` hooks (the redesign) is built as it is; the first
design gets them inserted. Each block's start and end are kept too, for
the launch's span.

``--parent DIR``: an earlier commit unpacked into a directory that
``.gitignore`` lists, e.g. the tree before the redesign::

    git archive c44a6d3 | tar -x -C .archive_check/parent

whose ``csrc/chol_tri_inverse.cu`` is built with the port's nvcc flags and
called through its own C entry point (its workspace sized by this tree's
formula, which is larger). ``--first-only`` (with ``--parent``) checks,
stamps and times only that tree's kernel. Prints the ptxas lines of every
build and the card's name, power limit and clocks.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from apvast_torch.ops import kernels as K  # noqa: E402
from apvast_torch.ops.kernels import _build  # noqa: E402
from apvast_torch.ops.kernels.whiten import chol_tri_inverse_workspace_floats  # noqa: E402
from k10b_panels import TOL, nvidia_smi, sweep, time_ms  # noqa: E402
from k2_k4_stages import (  # noqa: E402
    STAGE_BLOCKS, I, P, _call, _kernel_body, _replace_once, build, stage_blocks,
)

SHAPES = ((2, 800), (1, 1024))
LAUNCHES = 50
KINDS = {1: "F: warp factors", 2: "F: Neumann sub-inverses", 3: "F: strip solves",
         4: "F: in-panel updates", 5: "F: merge tree", 6: "F: load (first design: and store)",
         7: "waits (barriers, counters)", 8: "copy in", 9: "copy out", 10: "panel loads (S)",
         11: "solve tiles", 12: "inverse tiles", 13: "update tiles", 14: "F (whole)",
         15: "F: store and counter", 16: "look-ahead solve bands", 17: "look-ahead update bands",
         18: "look-ahead waits", 19: "inverse tiles' wait for F(p)",
         20: "look-ahead solve bands: staging", 21: "look-ahead update bands: staging",
         22: "F: Neumann products", 23: "F: Neumann barriers"}

# Added after the stamp header: thread 0 of every block adds the time since
# its last STAGE_ANY to the kind's sum (kind 0 only sets the time), and the
# SM clock cycles since then (clock64) to a second sum, so the SM's clock
# during the launch can be read (cycles per ns).
ANY_HEADER = r"""
__device__ unsigned long long stage_any_sum[32];
__device__ unsigned long long stage_any_cyc[32];
__device__ unsigned stage_any_n[32];
#define STAGE_ANY(kind)                                                         \
  do {                                                                          \
    if (threadIdx.x == 0) {                                                     \
      unsigned long long t_;                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                    \
      const unsigned long long c_ = (unsigned long long)clock64();              \
      if ((kind) > 0) {                                                         \
        atomicAdd(&stage_any_sum[kind], t_ - stage_last()[3]);                  \
        atomicAdd(&stage_any_cyc[kind], c_ - stage_last()[2]);                  \
        atomicAdd(&stage_any_n[kind], 1u);                                      \
      }                                                                         \
      stage_last()[3] = t_;                                                     \
      stage_last()[2] = c_;                                                     \
    }                                                                           \
  } while (0)
extern "C" int stage_any_reset() {
  unsigned long long z[32] = {};
  unsigned zn[32] = {};
  cudaError_t e = cudaMemcpyToSymbol(stage_any_sum, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(stage_any_cyc, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(stage_any_n, zn, sizeof(zn));
  return (int)e;
}
extern "C" int stage_any_read(unsigned long long* sum, unsigned long long* cyc, unsigned* n) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(sum, stage_any_sum, 32 * sizeof(long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cyc, stage_any_cyc, 32 * sizeof(long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, stage_any_n, 32 * sizeof(unsigned));
  return (int)e;
}
"""


def _insert_first_design_stamps(src: str) -> str:
    """The first design's chol_tri_inverse.cu with stamps: inside
    factor_panel (block 0's thread 0) after its load, each warp factor,
    Neumann sub-inverse, strip solve and in-panel update, the merges and
    the store; in the kernel after the copy in, every grid barrier and the
    copy out; and, for every block, its time in panel loads, solve, inverse
    and update tiles and at the barriers (STAGE_ANY)."""
    s = src
    s = _replace_once(s, "    I[r * kLd + c] = 0.f;\n  }\n  __syncthreads();\n",
                      "    I[r * kLd + c] = 0.f;\n  }\n  __syncthreads();\n  STAGE_STAMP(6);\n")
    s = _replace_once(s, "    if (tid < kSub) chol_sub_warp(D + g0 * kLd + g0);\n    __syncthreads();\n",
                      "    if (tid < kSub) chol_sub_warp(D + g0 * kLd + g0);\n    __syncthreads();\n"
                      "    STAGE_STAMP(1);\n")
    s = _replace_once(s, "S + 2 * kSub * kSubLd);\n    if (m == 0) break;\n",
                      "S + 2 * kSub * kSubLd);\n    STAGE_STAMP(2);\n    if (m == 0) break;\n")
    s = _replace_once(s, "    __syncthreads();\n    // In-panel trailing update, lower triangle only.\n",
                      "    __syncthreads();\n    STAGE_STAMP(3);\n"
                      "    // In-panel trailing update, lower triangle only.\n")
    s = _replace_once(s, "      D[(g1 + r) * kLd + g1 + c] -= acc;\n    }\n    __syncthreads();\n  }\n",
                      "      D[(g1 + r) * kLd + g1 + c] -= acc;\n    }\n    __syncthreads();\n"
                      "    STAGE_STAMP(4);\n  }\n")
    s = _replace_once(s, "  merge(D, I, S, 0, 2 * kSub);\n",
                      "  merge(D, I, S, 0, 2 * kSub);\n  STAGE_STAMP(5);\n")
    s = _replace_once(s, "    X[(size_t)(lo + r) * np + lo + c] = iv;\n  }\n}\n",
                      "    X[(size_t)(lo + r) * np + lo + c] = iv;\n  }\n  STAGE_STAMP(6);\n}\n")
    open_, close = _kernel_body(s, "chol_tri_inverse_kernel(Args a)")
    body = s[open_ + 1:close]
    body = _replace_once(body, "  grid.sync();\n  for (int p = 0; p < panels; ++p) {\n",
                         "  STAGE_STAMP(8);\n  STAGE_ANY(8);\n  grid.sync();\n  STAGE_STAMP(7);\n"
                         "  STAGE_ANY(7);\n  for (int p = 0; p < panels; ++p) {\n")
    body = _replace_once(body, "      factor_panel(a, b, p, smem);\n      __syncthreads();\n    }\n"
                               "    grid.sync();\n",
                         "      factor_panel(a, b, p, smem);\n      __syncthreads();\n"
                         "      STAGE_ANY(14);\n    }\n    grid.sync();\n    STAGE_STAMP(7);\n"
                         "    STAGE_ANY(7);\n")
    body = _replace_once(body, "        load_panel(a, b, p, D, I);\n        loaded = b;\n",
                         "        load_panel(a, b, p, D, I);\n        loaded = b;\n"
                         "        STAGE_STAMP(10);\n        STAGE_ANY(10);\n")
    body = _replace_once(body, "        solve_tile(a, b, lo, hi + k * kSolveRows, D, I, S);\n",
                         "        solve_tile(a, b, lo, hi + k * kSolveRows, D, I, S);\n"
                         "        STAGE_STAMP(11);\n        STAGE_ANY(11);\n")
    body = _replace_once(body, "        inverse_tile(a, b, lo, (k - solves) * kInvCols, D, I, S);\n",
                         "        inverse_tile(a, b, lo, (k - solves) * kInvCols, D, I, S);\n"
                         "        STAGE_STAMP(12);\n        STAGE_ANY(12);\n")
    body = _replace_once(body, "    grid.sync();\n    if (hi == np) break;\n",
                         "    grid.sync();\n    STAGE_STAMP(7);\n    STAGE_ANY(7);\n"
                         "    if (hi == np) break;\n")
    body = _replace_once(body, "      update_tile(a, b, lo, hi + ti * kTile, hi + tj * kTile, S);\n"
                               "      __syncthreads();\n",
                         "      update_tile(a, b, lo, hi + ti * kTile, hi + tj * kTile, S);\n"
                         "      __syncthreads();\n      STAGE_STAMP(13);\n      STAGE_ANY(13);\n")
    body = _replace_once(body, "    }\n    grid.sync();\n  }\n",
                         "    }\n    grid.sync();\n    STAGE_STAMP(7);\n    STAGE_ANY(7);\n  }\n")
    body = ("\n  STAGE_STAMP(0);\n  STAGE_ANY(0);\n  STAGE_BLOCK(0);" + body
            + "  STAGE_STAMP(9);\n  STAGE_ANY(9);\n  STAGE_BLOCK(1);\n")
    return s[:open_ + 1] + body + s[close:]


def _stamped_source(csrc: str, out_dir: str, label: str) -> str:
    """Path of ``label``'s stamped source: the tool's STAGE_ANY header, then
    the source with its own hooks or with the first design's inserted."""
    with open(os.path.join(csrc, "chol_tri_inverse.cu")) as f:
        src = f.read()
    if "STAGE_STAMP(" not in src:
        src = _insert_first_design_stamps(src)
    path = os.path.join(out_dir, f"{label}_chol_tri_inverse_stamped_src.cu")
    with open(path, "w") as f:
        f.write(ANY_HEADER + src)
    return path


def launcher(lib: ctypes.CDLL):
    """K10b through a library's own C entry point."""
    def run(b: torch.Tensor) -> torch.Tensor:
        bz, n, _ = b.shape
        npad = -(-n // 128) * 128
        out = torch.empty_like(b)
        ws = torch.empty(chol_tri_inverse_workspace_floats(bz, npad), device=b.device)
        _call(lib.chol_tri_inverse_launch, [P, P, P, I, I, I], b.data_ptr(), out.data_ptr(),
              ws.data_ptr(), bz, n, npad)
        return out
    return run


def check(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
    err = float((got.double() - want.double()).abs().max() / want.double().abs().max())
    upper = float(torch.triu(got, 1).abs().max())
    print(f"{label}: against plain {err:.3e}, max |upper| {upper}", flush=True)
    if not (err <= TOL and upper == 0.0):
        raise AssertionError(f"{label}: {err:.3e} > {TOL} or nonzero upper triangle")


def stages(label: str, lib: ctypes.CDLL, fn, flush: torch.Tensor) -> None:
    """Block 0's stamps (the critical path) and every block's per-kind sums,
    means over LAUNCHES flushed launches, and the last launch's span."""
    sums, counts = (ctypes.c_ulonglong * 32)(), (ctypes.c_uint * 32)()
    any_sums, any_counts = (ctypes.c_ulonglong * 32)(), (ctypes.c_uint * 32)()
    any_cyc = (ctypes.c_ulonglong * 32)()
    cycles = ns = 0
    crit: dict[int, float] = {}
    work: dict[int, float] = {}
    n_crit: dict[int, int] = {}
    n_work: dict[int, int] = {}
    for i in range(LAUNCHES + 3):
        flush.sum()
        lib.stage_reset()
        lib.stage_any_reset()
        fn()
        if lib.stage_read(sums, counts) or lib.stage_any_read(any_sums, any_cyc, any_counts):
            raise RuntimeError("stage_read failed")
        if i < 3:
            continue
        cycles += sum(any_cyc)
        ns += sum(any_sums)
        for k in range(1, 32):
            if counts[k]:
                crit[k] = crit.get(k, 0.0) + sums[k] * 1e-6 / LAUNCHES
                n_crit[k] = counts[k]
            if any_counts[k]:
                work[k] = work.get(k, 0.0) + any_sums[k] * 1e-6 / LAUNCHES
                n_work[k] = any_counts[k]
    starts, ends = stage_blocks(lib)[:2]
    timed = [b for b in range(STAGE_BLOCKS) if starts[b] and ends[b]]
    t0 = min(starts[b] for b in timed)
    span = (max(ends[b] for b in timed) - t0) * 1e-6
    busy = sum(v for k, v in work.items() if k != 7)
    print(f"{label} critical path (ms, block 0's stamps, mean of {LAUNCHES}; first to last "
          f"{sum(crit.values()):.5f}): "
          + ", ".join(f"{KINDS.get(k, k)} {v:.5f} ({n_crit[k]})" for k, v in sorted(crit.items())),
          flush=True)
    print(f"{label} sum of the stages over {len(timed)} blocks (block-ms, mean of {LAUNCHES}; "
          f"work {busy:.5f}, so {busy / len(timed):.5f} a block): "
          + ", ".join(f"{KINDS.get(k, k)} {v:.5f} ({n_work[k]})" for k, v in sorted(work.items())),
          flush=True)
    print(f"{label} last launch: {len(timed)} blocks start within "
          f"{(max(starts[b] for b in timed) - t0) * 1e-3:.2f} us, span {span:.5f} ms; SM clock "
          f"over the stamped intervals {cycles / max(ns, 1) * 1e3:.0f} MHz", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose K10b to time beside this one")
    ap.add_argument("--first-only", action="store_true",
                    help="with --parent: only that tree's kernel (checked, stamped, timed)")
    ap.add_argument("--no-sweep", action="store_true", help="skip the sweep over panel counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.first_only and not args.parent:
        ap.error("--first-only needs --parent")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(nvidia_smi(), flush=True)
    stage_dir = os.path.join(_build.BUILD_DIR, "stages")
    os.makedirs(stage_dir, exist_ok=True)
    trees = {}
    if args.parent:
        trees["parent"] = os.path.join(os.path.abspath(args.parent), "apvast_torch", "csrc")
    if not args.first_only:
        trees["this"] = _build.CSRC
    jobs = {}
    for tree, csrc in trees.items():
        jobs[tree] = (os.path.join(csrc, "chol_tri_inverse.cu"), False, ())
        jobs[f"{tree} stamped"] = (_stamped_source(csrc, stage_dir, tree), True,
                                   ("-I", csrc))
    libs = build(jobs, stage_dir)
    forms = {name: launcher(lib) for name, lib in libs.items()}
    if "this" in trees:
        _build.build_all(("chol_tri_inverse", "whiten"))  # the wrappers' own libraries

    g = torch.Generator().manual_seed(1)
    inputs = {}
    for bz, n in SHAPES:
        x = torch.randn((bz, n, n), generator=g)
        inputs[(bz, n)] = (x @ x.transpose(1, 2) / n + torch.eye(n)).to(dev).contiguous()
    for name, fn in forms.items():
        for shape, b in inputs.items():
            check(f"{name} {shape}", fn(b), K.chol_tri_inverse_plain(b))
    for r in range(3):
        b = inputs[SHAPES[0]]
        for name, fn in forms.items():
            if not torch.equal(fn(b), fn(b)):
                raise AssertionError(f"{name}: two launches differ")
    print("every build repeats bit for bit", flush=True)

    flush = torch.zeros(64 * 2**20 // 4, device=dev)
    for tree in trees:
        for shape, b in inputs.items():
            stages(f"{tree} {shape}", libs[f"{tree} stamped"],
                   lambda fn=forms[f"{tree} stamped"], b=b: fn(b), flush)
    series = (["parent"] if args.parent else []) + (["this", "this"] if "this" in trees else [])
    series += ["parent"] if args.parent and "this" in trees else []
    for shape, b in inputs.items():
        times = [(t, time_ms(lambda fn=forms[t], b=b: fn(b), flush, iters=LAUNCHES))
                 for t in series]
        print(f"K10b {shape}, flushed, spin: " + ", ".join(f"{t} {ms:.5f}" for t, ms in times)
              + " ms", flush=True)
    if "this" in trees:
        b = inputs[SHAPES[0]]
        print(f"K10b {SHAPES[0]} through this tree's wrapper: "
              f"{time_ms(lambda: K.chol_tri_inverse(b), flush, iters=LAUNCHES):.5f} ms", flush=True)
    if not args.no_sweep:
        sweep({f"K10b {t}": forms[t] for t in trees}, flush)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
