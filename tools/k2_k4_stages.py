"""Time kernels K2 (lag correlations) and K4 (real Jacobi eigensolver) on one
CUDA card, split each into its stages, and optionally time an earlier
tree's K2 and K4 beside them, in one process.

    python3 tools/k2_k4_stages.py [--parent DIR] [--stages-only]

Shapes: K2 at the north star, x (4, 17, 17, 999) with J = 50 (16 sources
and the target row, 17 mics), and at 33 sources, x (4, 33, 33, 999)
(``scale_scene(32)``'s K2); K4 at the tracking solver's (2, 64, 64), on a
warm-start-like input (spread diagonal, small symmetric perturbation),
at 2, 3 and 8 sweeps. Every kernel timed here is first held against its
plain version (max |x - plain| / max |plain| <= 1e-4), and the script
stops if one is not; this tree's K4 pair-block form is also held against
its template form, bit for bit (w and v).

Times: CUDA-event means with the L2 flushed before every launch, in the
order parent, this tree, this tree, parent.

K4's pair-block form at 64 slots is built once per warp count in
``WARPS`` and per round form (``-DK4_PAIR_WARPS=...``,
``-DK4_PIPELINED=0|1``: two block barriers a round, the rotations and the
updates one after the other, or pipelined, warp 0 computing the next
round's rotations while the others update this round), and each build is
checked against the template form and timed; stamped builds of some also
split a round by role (the rotations, a row of V, a thread's blocks).

Stages: each source is built again (into ``apvast_torch/_build/stages/``)
with ``%globaltimer`` stamps that only this build has: thread 0 of block 0
reads the timer at the kernel's start and at the end of every stage, and
adds the time since the last stamp to the stamp's kind. A source that has
its own ``STAGE_STAMP(kind)`` hooks is built as it is; one without them
(the first designs) gets them inserted: K2's staging loads, the barrier
after them, the FMA loop, the barrier after it (per mic: the sums over
the mics divided by M) and the store; K4's load, the rotation phase, the
barrier after it, the update phase, the barrier after it, and the ranking
and output gather. Printed per kind as means over 50 launches. The
stamped builds are checked against the plain version like the others.

``--parent DIR``: an earlier commit unpacked into a directory that
``.gitignore`` lists, e.g. the tree before the redesign::

    git archive 3d0c841 | tar -x -C .archive_check/parent

whose ``csrc/lag_corr.cu`` and ``csrc/jacobi_eigh.cu`` are built with the
port's nvcc flags and called through their own C entry points. Prints the
ptxas lines of every build and the card's name, power limit and clocks.
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
from apvast_torch.ops.kernels.jacobi_eigh import exports, pair_table, schedule  # noqa: E402

K2_SHAPES = {"north star (4, 17, 17, 999), J 50": ((4, 17, 17, 999), 50),
             "33 sources (4, 33, 33, 999), J 50": ((4, 33, 33, 999), 50)}
K4_SHAPE, K4_SWEEPS = (2, 64), (2, 3, 8)
WARPS = (4, 8, 16)  # two barriers a round
PIPE_WARPS = (8, 12, 16)  # pipelined: at least 5 (warp 0, V's 2, the producers' 2)
STAMPED_K4 = ((16, 0), (16, 1))  # also split into stages
TOL = 1e-4
LAUNCHES = 50
KINDS = {1: "staging loads", 2: "barrier after staging", 3: "FMA loop",
         4: "barrier after the FMA loop", 5: "store", 6: "partial sums (grid)",
         7: "grid barrier", 10: "load", 11: "rotation phase", 12: "barrier after rotations",
         13: "update phase", 14: "barrier after updates", 15: "ranking and output gather",
         16: "wait for the export blocks (warp 0)", 17: "next round's rotations",
         18: "the last warp's blocks (a thread)", 19: "a row of V"}

# Prepended to a source for its stamped build: per-kind sums of the time
# since the previous stamp, kept by thread 0 of block (0, 0, 0); the last
# stamp's time in shared memory and the sums added by fire-and-forget
# atomics, so that a stamp does not wait on a global round trip.
STAMP_HEADER = r"""
#include <cuda_runtime.h>
__device__ unsigned long long stage_sum[32];
__device__ unsigned stage_n[32];
__device__ __forceinline__ unsigned long long* stage_last() {
  __shared__ unsigned long long last[4];
  return last;
}
// Kind 0 only sets the slot's time; `slot` keeps one stamping thread's last time.
#define STAGE_STAMP_AT(kind, thread, slot)                                      \
  do {                                                                          \
    if ((blockIdx.x | blockIdx.y | blockIdx.z) == 0 && threadIdx.x == (thread)) { \
      unsigned long long t_;                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                    \
      if ((kind) > 0) {                                                         \
        atomicAdd(&stage_sum[kind], t_ - stage_last()[slot]);                   \
        atomicAdd(&stage_n[kind], 1u);                                          \
      }                                                                         \
      stage_last()[slot] = t_;                                                  \
    }                                                                           \
  } while (0)
#define STAGE_STAMP(kind) STAGE_STAMP_AT(kind, 0, 0)
// Per block (linear index, the first STAGE_BLOCKS of the grid) and kind.
#define STAGE_BLOCKS 4096
__device__ unsigned long long stage_block[4][STAGE_BLOCKS];
#define STAGE_BLOCK(kind)                                                       \
  do {                                                                          \
    const unsigned b_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \
    if (threadIdx.x == 0 && b_ < STAGE_BLOCKS) {                                \
      unsigned long long t_;                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                    \
      stage_block[kind][b_] = t_;                                               \
    }                                                                           \
  } while (0)
extern "C" int stage_blocks(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, stage_block, sizeof(stage_block));
  return (int)e;
}
extern "C" int stage_reset() {
  static unsigned long long zb[4][STAGE_BLOCKS];
  unsigned long long z[32] = {};
  unsigned zn[32] = {};
  cudaError_t e = cudaMemcpyToSymbol(stage_sum, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(stage_n, zn, sizeof(zn));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(stage_block, zb, sizeof(zb));
  return (int)e;
}
extern "C" int stage_read(unsigned long long* sum, unsigned* n) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(sum, stage_sum, 32 * sizeof(long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, stage_n, 32 * sizeof(unsigned));
  return (int)e;
}
"""


STAGE_BLOCKS = 4096  # the header's STAGE_BLOCKS


def stage_blocks(lib: ctypes.CDLL) -> list[list[int]]:
    """The last stamped launch's per-block timer reads, by kind (0-3)."""
    blocks = (ctypes.c_ulonglong * (4 * STAGE_BLOCKS))()
    if lib.stage_blocks(blocks):
        raise RuntimeError("stage_blocks failed")
    return [list(blocks[k * STAGE_BLOCKS:(k + 1) * STAGE_BLOCKS]) for k in range(4)]


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


def _replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"anchor not found once: {old!r}")
    return src.replace(old, new)


def _insert_k2_stamps(src: str) -> str:
    """The first design's lag_corr.cu with stamps around its two barriers a
    staging round, after the mic loop and at the end."""
    open_, close = _kernel_body(src, "lag_corr_kernel(")
    body = src[open_ + 1:close]
    body = _replace_once(body, "      }\n      __syncthreads();\n      const int tmax",
                         "      }\n      STAGE_STAMP(1);\n      __syncthreads();\n"
                         "      STAGE_STAMP(2);\n      const int tmax")
    body = _replace_once(body, "      }\n      __syncthreads();\n    }\n  }\n",
                         "      }\n      STAGE_STAMP(3);\n      __syncthreads();\n"
                         "      STAGE_STAMP(4);\n    }\n  }\n")
    body = _replace_once(body, "  if (l >= j) return;", "  if (l >= j) { STAGE_STAMP(5); return; }")
    return src[:open_ + 1] + "\n  STAGE_STAMP(0);" + body + "  STAGE_STAMP(5);\n" + src[close:]


def _insert_k4_stamps(src: str) -> str:
    """The first design's jacobi_eigh.cu with stamps after the load, around
    the template form's two barriers a round (double-buffered form) and
    after the ranking and output gather."""
    open_, close = _kernel_body(src, "jacobi_eigh_kernel(const float*")
    body = src[open_ + 1:close]
    body = _replace_once(body, "    cnt[i] = 0;\n  }\n  __syncthreads();\n",
                         "    cnt[i] = 0;\n  }\n  __syncthreads();\n  STAGE_STAMP(10);\n")
    body = _replace_once(body, "      pair_rotations(A, cs, np, tid, nt);\n      __syncthreads();\n",
                         "      pair_rotations(A, cs, np, tid, nt);\n      STAGE_STAMP(11);\n"
                         "      __syncthreads();\n      STAGE_STAMP(12);\n")
    body = _replace_once(
        body, "          if (e < nn) rotate_entry(packed[k], np, A, V, cs, A2[e], V2[e]);\n"
              "        }\n        __syncthreads();\n",
        "          if (e < nn) rotate_entry(packed[k], np, A, V, cs, A2[e], V2[e]);\n"
        "        }\n        STAGE_STAMP(13);\n        __syncthreads();\n        STAGE_STAMP(14);\n")
    body = _replace_once(body, "    return;\n  }\n", "    STAGE_STAMP(15);\n    return;\n  }\n")
    return src[:open_ + 1] + "\n  STAGE_STAMP(0);" + body + "  STAGE_STAMP(15);\n" + src[close:]


def build(jobs: dict[str, tuple[str, bool, tuple[str, ...]]],
          out_dir: str) -> dict[str, ctypes.CDLL]:
    """name -> (source path, stamped, extra nvcc flags): one nvcc per build,
    all at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (path, stamped, flags) in jobs.items():
        with open(path) as f:
            src = f.read()
        if stamped:
            if "STAGE_STAMP" not in src:  # STAGE_STAMP(kind) or STAGE_STAMP_AT(...)
                src = (_insert_k2_stamps(src) if "lag_corr_kernel" in src
                       else _insert_k4_stamps(src))
            src = STAMP_HEADER + src
        out = os.path.join(out_dir, name.replace(" ", "_").replace(",", "") + ".cu")
        with open(out, "w") as f:
            f.write(src)
        # Headers included by the source resolve against its own csrc.
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", os.path.dirname(path),
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


def _call(fn, argtypes, *args) -> int:
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return err


P, I = ctypes.c_void_p, ctypes.c_int


def k2_launcher(lib: ctypes.CDLL):
    """K2 through a library's own entry point: the first design's
    (x, out, p4, m, s, n, j), or the redesign's with its workspace."""
    def run(x, j):
        p4, m, s, n = x.shape
        out = torch.empty((p4, s, s, j), device=x.device)
        if hasattr(lib, "lag_corr_workspace_floats"):
            f = lib.lag_corr_workspace_floats
            f.argtypes, f.restype = [I] * 5, ctypes.c_long
            floats = f(p4, m, s, n, j)
            if floats < 0:
                raise RuntimeError(f"lag_corr_workspace_floats: cudaError {-floats}")
            ws = torch.empty(max(floats, 1), device=x.device)
            _call(lib.lag_corr_launch, [P, P, P] + [I] * 5, x.data_ptr(), out.data_ptr(),
                  ws.data_ptr(), p4, m, s, n, j)
        else:
            _call(lib.lag_corr_launch, [P, P] + [I] * 5, x.data_ptr(), out.data_ptr(),
                  p4, m, s, n, j)
        return out
    return run


def k4_launcher(lib: ctypes.CDLL, form: str):
    """K4 at <= 160 slots through a library's entry point: ``pair`` (this
    tree's jacobi_eigh_launch, by width), ``template`` (this tree's
    template form, or an earlier tree's only form)."""
    def run(a, sweeps):
        bz, n, _ = a.shape
        npad = max(8, -(-n // 8) * 8)
        w = torch.empty((bz, n), device=a.device)
        v = torch.empty((bz, n, n), device=a.device)
        src = schedule(npad, a.device)
        if form == "pair":
            _call(lib.jacobi_eigh_launch, [P] * 7 + [I] * 4, a.data_ptr(), src.data_ptr(),
                  pair_table(npad, a.device).data_ptr(), exports(npad, a.device).data_ptr(),
                  w.data_ptr(), v.data_ptr(), None, bz, n, npad, sweeps)
        else:
            entry = (lib.jacobi_eigh_template_launch
                     if hasattr(lib, "jacobi_eigh_template_launch") else lib.jacobi_eigh_launch)
            _call(entry, [P] * 5 + [I] * 4, a.data_ptr(), src.data_ptr(), w.data_ptr(),
                  v.data_ptr(), None, bz, n, npad, sweeps)
        return w, v
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
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [float((x.double() - w.double()).abs().max() / w.double().abs().max())
            for x, w in zip(got, want)]
    print(f"{label}: against plain {[f'{e:.3e}' for e in errs]}", flush=True)
    if not max(errs) <= TOL:
        raise AssertionError(f"{label}: {max(errs):.3e} > {TOL}")


def same_bits(label: str, got, want) -> None:
    diffs = [float((x - w).abs().max()) for x, w in zip(got, want)]
    print(f"{label}: max |pair - template| {diffs}", flush=True)
    if not all(torch.equal(x, w) for x, w in zip(got, want)):
        raise AssertionError(f"{label}: the pair form differs from the template form")


def stages(label: str, lib: ctypes.CDLL, fn, flush: torch.Tensor, per: int = 1) -> None:
    """Mean time per stage kind (ms) over LAUNCHES stamped launches, and the
    number of stamps of each kind a launch; ``per`` divides the sums (K2's
    per-mic split)."""
    sums = (ctypes.c_ulonglong * 32)()
    counts = (ctypes.c_uint * 32)()
    totals: dict[int, float] = {}
    n_of: dict[int, int] = {}
    for i in range(LAUNCHES + 3):
        flush.sum()
        lib.stage_reset()
        fn()
        if lib.stage_read(sums, counts):
            raise RuntimeError("stage_read failed")
        if i < 3:
            continue
        for k in range(1, 32):
            if counts[k]:
                totals[k] = totals.get(k, 0.0) + sums[k] * 1e-6 / LAUNCHES
                n_of[k] = counts[k]
    starts, ends, landed, fmas = stage_blocks(lib)
    timed = [b for b in range(STAGE_BLOCKS) if starts[b] and ends[b]]
    if timed:
        t0 = min(starts[b] for b in timed)

        def spread(xs):
            us = sorted((xs[b] - t0) * 1e-3 for b in timed if xs[b])
            return f"min {us[0]:.2f} median {us[len(us) // 2]:.2f} max {us[-1]:.2f}" if us else "-"

        slow = sorted(timed, key=lambda b: ends[b], reverse=True)[:8]
        print(f"{label} blocks (last launch, us from the first block's start): {len(timed)} "
              f"blocks, starts within {(max(starts[b] for b in timed) - t0) * 1e-3:.2f}; first "
              f"chunk staged {spread(landed)}; last chunk's FMAs done {spread(fmas)}; end of "
              f"phase 1 {spread(ends)}; slowest (block: start, end) "
              + ", ".join(f"{b}: {(starts[b] - t0) * 1e-3:.2f}, {(ends[b] - t0) * 1e-3:.2f}"
                          for b in slow), flush=True)
    whole = sum(totals.values())
    per_txt = f"; kinds 1-4 per mic (/{per})" if per > 1 else ""
    print(f"{label} stages (ms, mean of {LAUNCHES}; block 0 thread 0's stamps, first to "
          f"last {whole:.5f}{per_txt}): "
          + ", ".join(f"{KINDS.get(k, k)} {v / (per if k <= 4 else 1):.5f} ({n_of[k]} stamps)"
                      for k, v in sorted(totals.items())), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose K2 and K4 to time beside this one")
    ap.add_argument("--stages-only", action="store_true",
                    help="only check the builds and split them into stages (no timing series)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for name, (secs, log) in _build.build_all(("lag_corr", "jacobi_eigh")).items():
        print(f"built {name} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    csrc_this = _build.CSRC
    with open(os.path.join(csrc_this, "jacobi_eigh.cu")) as f:
        has_pair = "jacobi_eigh_template_launch" in f.read()
    jobs = {"this k2 stamped": (os.path.join(csrc_this, "lag_corr.cu"), True, ()),
            "this k4 stamped": (os.path.join(csrc_this, "jacobi_eigh.cu"), True, ())}
    k2_variants = {"chunk64": ("-DK2_CHUNK=64",), "chunk128": ("-DK2_CHUNK=128",)}
    for v, flags in k2_variants.items():
        jobs[f"this k2 {v}"] = (os.path.join(csrc_this, "lag_corr.cu"), False, flags)
    variants = []
    if has_pair:
        variants = [(w, 0) for w in WARPS] + [(w, 1) for w in PIPE_WARPS]
        for w, b in variants:
            jobs[f"this k4 w{w} pipe{b}"] = (os.path.join(csrc_this, "jacobi_eigh.cu"), False,
                                             (f"-DK4_PAIR_WARPS={w}", f"-DK4_PIPELINED={b}"))
        for w, b in STAMPED_K4:
            jobs[f"this k4 stamped w{w} pipe{b}"] = (
                os.path.join(csrc_this, "jacobi_eigh.cu"), True,
                (f"-DK4_PAIR_WARPS={w}", f"-DK4_PIPELINED={b}"))
    if args.parent:
        csrc = os.path.join(os.path.abspath(args.parent), "apvast_torch", "csrc")
        jobs |= {"parent k2": (os.path.join(csrc, "lag_corr.cu"), False, ()),
                 "parent k4": (os.path.join(csrc, "jacobi_eigh.cu"), False, ()),
                 "parent k2 stamped": (os.path.join(csrc, "lag_corr.cu"), True, ()),
                 "parent k4 stamped": (os.path.join(csrc, "jacobi_eigh.cu"), True, ())}
    libs = build(jobs, os.path.join(_build.BUILD_DIR, "stages"))

    g = torch.Generator().manual_seed(0)
    x2 = {label: (torch.randn(shape, generator=g) * 1e-3).to(dev)
          for label, (shape, _) in K2_SHAPES.items()}
    bz, n = K4_SHAPE
    e = 1e-2 * torch.randn((bz, n, n), generator=g)
    a4 = (torch.diag_embed(torch.linspace(-3.0, 5.0, n).repeat(bz, 1))
          + (e + e.transpose(1, 2)) / 2).to(dev).contiguous()
    flush = torch.zeros(64 * 2**20 // 4, device=dev)

    k2_forms = {"this": lambda x, j: K.lag_corr(x, j),
                "this stamped": k2_launcher(libs["this k2 stamped"])}
    for v in k2_variants:
        k2_forms[f"this {v}"] = k2_launcher(libs[f"this k2 {v}"])
    k4_this_form = "pair" if has_pair else "template"
    k4_forms = {"this": lambda a, s: K.jacobi_eigh(a, s),
                "this stamped": k4_launcher(libs["this k4 stamped"], k4_this_form)}
    if has_pair:
        k4_forms["this template"] = k4_launcher(libs["this k4 stamped"], "template")
        for w, b in variants:
            k4_forms[f"this w{w} pipe{b}"] = k4_launcher(libs[f"this k4 w{w} pipe{b}"], "pair")
        for w, b in STAMPED_K4:
            k4_forms[f"this stamped w{w} pipe{b}"] = k4_launcher(
                libs[f"this k4 stamped w{w} pipe{b}"], "pair")
    if args.parent:
        k2_forms |= {"parent": k2_launcher(libs["parent k2"]),
                     "parent stamped": k2_launcher(libs["parent k2 stamped"])}
        k4_forms |= {"parent": k4_launcher(libs["parent k4"], "template"),
                     "parent stamped": k4_launcher(libs["parent k4 stamped"], "template")}

    for label, (_, j) in K2_SHAPES.items():
        want = K.lag_corr_plain(x2[label], j)
        first = None
        for name, fn in k2_forms.items():
            got = fn(x2[label], j)
            check(f"K2 {label} {name}", got, want)
            if name == "this":
                first = got
        again = K.lag_corr(x2[label], j)
        torch.cuda.synchronize()
        print(f"K2 {label} this: repeats bit for bit {torch.equal(first, again)}", flush=True)
    for sweeps in K4_SWEEPS:
        want = K.jacobi_eigh_plain(a4, sweeps)
        ref = k4_forms["this template"](a4, sweeps) if has_pair else None
        for name, fn in k4_forms.items():
            got = fn(a4, sweeps)
            check(f"K4 {K4_SHAPE} {sweeps} sweeps {name}", got, want)
            if ref is not None and name != "this template" and not name.startswith("parent"):
                same_bits(f"K4 {K4_SHAPE} {sweeps} sweeps {name}", got, ref)

    if not args.stages_only:
        order = ["parent", "this", "this", "parent"] if args.parent else ["this", "this"]
        for label, (_, j) in K2_SHAPES.items():
            times: dict[str, list[float]] = {}
            for name in order:
                times.setdefault(name, []).append(
                    time_ms(lambda: k2_forms[name](x2[label], j), flush))
            for v in k2_variants:
                times[f"this {v}"] = [time_ms(lambda: k2_forms[f"this {v}"](x2[label], j), flush)]
            print(f"K2 {label} ms per call: "
                  f"{ {k: [round(t, 5) for t in v] for k, v in times.items()} }", flush=True)
        for sweeps in K4_SWEEPS:
            times = {}
            for name in order:
                times.setdefault(name, []).append(
                    time_ms(lambda: k4_forms[name](a4, sweeps), flush))
            for name in ["this template"] + [f"this w{w} pipe{b}" for w, b in variants]:
                if name in k4_forms:
                    times[name] = [time_ms(lambda: k4_forms[name](a4, sweeps), flush)]
            print(f"K4 {K4_SHAPE}, {sweeps} sweeps, ms per call: "
                  f"{ {k: [round(t, 5) for t in v] for k, v in times.items()} }", flush=True)

    for who in (["parent", "this"] if args.parent else ["this"]):
        for label, ((_, m, _, _), j) in K2_SHAPES.items():
            # The first design stages every mic; the redesign stages chunks of
            # its depth slice, so its kinds are not split per mic.
            per = m if who == "parent" else 1
            stages(f"K2 {who} {label}", libs[f"{who} k2 stamped"],
                   lambda: k2_forms[f"{who} stamped"](x2[label], j), flush, per=per)
        for sweeps in K4_SWEEPS:
            stages(f"K4 {who} {K4_SHAPE} {sweeps} sweeps", libs[f"{who} k4 stamped"],
                   lambda: k4_forms[f"{who} stamped"](a4, sweeps), flush)
    if has_pair:
        for w, b in STAMPED_K4:
            stages(f"K4 this w{w} pipe{b} {K4_SHAPE} 2 sweeps", libs[f"this k4 stamped w{w} pipe{b}"],
                   lambda: k4_forms[f"this stamped w{w} pipe{b}"](a4, 2), flush)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
