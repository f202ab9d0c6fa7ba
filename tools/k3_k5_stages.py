"""Time kernels K3 (skew assembly, both forms), K5 (fused output filter)
and K11 (K5's unfused form) on one CUDA card, split each into its stages,
and optionally time an earlier tree's K3, K5 and K11 beside them, in one
process.

    python3 tools/k3_k5_stages.py [--parent DIR] [--first-only]

Shapes: the north star's and ``scale_scene(32)``'s. K3: lhs_t (4, J*S,
C), rhs (4, C, S*J), c0 (4, S, S*J) with (S, J, C) = (16, 50, 34) and
(32, 50, 66). K5: x (2, 1600), filters (2, V*S, 50), tail (2, V*S, 800),
hop 800, with V*S = 800 and 1600; K11 the same x and filters. Every
kernel timed here is first held against its plain version (max |x -
plain| / max |plain| <= 1e-4), and the script stops if one is not.

Times: CUDA-event means over 50 launches, with the L2 flushed before
every launch (a 64 MB read) and warm (launch after launch, inputs and
outputs left in the L2, as the hop finds K5's tail, written by the hop
before), in the order parent, this tree, this tree, parent. Before each
timed launch the card spins ~0.1 ms (``torch.cuda._sleep``) while the
host enqueues it, so the events time the device; the north star is also
timed without the spin (the events then take in the host's path when the
launch is shorter), and through this tree's wrappers both ways.

Stages: each source is built again (into ``apvast_torch/_build/stages/``)
with ``%globaltimer`` stamps that only this build has
(``tools/k2_k4_stages.py``'s header): a stamping thread of block 0 reads
the timer at the kernel's start and at the end of every stage, and adds
the time since the last stamp to the stamp's kind; thread 0 of every
block (the first 4096) stamps the block's start and end. A source with
its own ``STAGE_STAMP(kind)`` hooks (this tree's) is built as it is; the
first designs get them inserted: K3's staging loads, the barrier, the
dot products and the running sum with its row store (stamped by the
thread of lane diagonal J-1, the one that walks all J steps); K5's
staging, the barrier, the FMA loop and the epilogue. Printed per kind as
means over 50 flushed launches, with the spread of the blocks' ends.

``--parent DIR``: an earlier commit unpacked into a directory that
``.gitignore`` lists, e.g. the tree before the redesign::

    git archive b8e6361 | tar -x -C .archive_check/parent

whose ``csrc/skew_assembly.cu`` and ``csrc/output_filter.cu`` are built
with the port's nvcc flags and called through their own C entry points.
``--first-only`` (with ``--parent``) builds, checks, stamps and times only
that tree's kernels. Prints the ptxas lines of every build and the card's
name, power limit and clocks.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from apvast_torch.ops import kernels as K  # noqa: E402
from apvast_torch.ops.kernels import _build  # noqa: E402
from apvast_torch.ops.kernels.skew_assembly import skew_plan  # noqa: E402
from k2_k4_stages import (  # noqa: E402
    STAGE_BLOCKS, I, P, _call, _kernel_body, _replace_once, build, check, stage_blocks,
)

K3_SHAPES = {"north star": (16, 50, 34), "32 sources": (32, 50, 66)}  # (S, J, C), P = 4
K5_SHAPES = {"north star": 800, "32 sources": 1600}  # filter rows V*S; J = 50 taps
BLOCK, HOP, TAPS = 1600, 800, 50
LAUNCHES = 50
SPIN_CYCLES = 200_000  # chip_smoke.py's
KINDS = {1: "staging", 2: "barrier after staging", 3: "product (K3) / FMA loop (K5, K11)",
         4: "barrier after the product", 6: "diagonal sums", 7: "barrier after the sums",
         5: "row store (first design: with the running sum)", 8: "tail wait and barrier",
         9: "epilogue"}


def _insert_k3_stamps(src: str) -> str:
    """The first design's skew_assembly.cu with stamps by the thread of
    lane diagonal J-1 of block 0 (it walks every step): after the staging
    loads and the barrier, and per step after the dot product and after
    the running sum's store (or the zero store)."""
    open_, close = _kernel_body(src, "skew_assembly_kernel(")
    body = src[open_ + 1:close]
    stamp = "STAGE_STAMP_AT({}, (j - 1) % kLanes, 1);"
    body = _replace_once(body, "  }\n  __syncthreads();\n  if (wi >= w) return;",
                         f"  }}\n  {stamp.format(1)}\n  __syncthreads();\n  {stamp.format(2)}\n"
                         "  if (wi >= w) return;")
    body = _replace_once(body, "dot = fmaf(la[cc], rp[(size_t)cc * w + lane], dot);\n",
                         f"dot = fmaf(la[cc], rp[(size_t)cc * w + lane], dot);\n"
                         f"      {stamp.format(3)}\n")
    body = _replace_once(body, "      op[row + lane] = kHalf ? acc * scale : acc;\n",
                         f"      op[row + lane] = kHalf ? acc * scale : acc;\n"
                         f"      {stamp.format(5)}\n")
    body = _replace_once(body, "      op[row + s2 * j + (dd - a + j)] = 0.f;\n",
                         f"      op[row + s2 * j + (dd - a + j)] = 0.f;\n"
                         f"      {stamp.format(5)}\n")
    return (src[:open_ + 1] + f"\n  {stamp.format(0)}\n  STAGE_BLOCK(0);" + body
            + "  STAGE_BLOCK(1);\n" + src[close:])


def _insert_k5_stamps(src: str) -> str:
    """The first design's output_filter.cu with stamps by thread 0 of block
    0 after the staging loads, the barrier, the FMA loop and the epilogue
    (both forms)."""
    open_, close = _kernel_body(src, "output_filter_kernel(")
    body = src[open_ + 1:close]
    body = _replace_once(body, "    es[u] = xz[g];\n  }\n  __syncthreads();\n",
                         "    es[u] = xz[g];\n  }\n  STAGE_STAMP(1);\n  __syncthreads();\n"
                         "  STAGE_STAMP(2);\n")
    body = _replace_once(body, "  const int n = n0 + tx;\n",
                         "  STAGE_STAMP(3);\n  const int n = n0 + tx;\n")
    body = _replace_once(body, "    }\n    return;\n  }\n",
                         "    }\n    STAGE_STAMP(9);\n    STAGE_BLOCK(1);\n    return;\n  }\n")
    return (src[:open_ + 1] + "\n  STAGE_STAMP(0);\n  STAGE_BLOCK(0);" + body
            + "  STAGE_STAMP(9);\n  STAGE_BLOCK(1);\n" + src[close:])


def k3_launcher(lib: ctypes.CDLL, planned: bool):
    """K3 through a library's own entry point; ``planned``: the redesign's,
    which takes the wrapper's plan (g, band)."""
    def run(lhs, rhs, c0, j, half):
        p, js1, c = lhs.shape
        s1, w = js1 // j, rhs.shape[-1]
        out = torch.empty((p, s1, j, w), device=lhs.device)
        args = [lhs.data_ptr(), rhs.data_ptr(), c0.data_ptr(), out.data_ptr(),
                p, s1, j, c, w, int(half)]
        if planned:
            args += list(skew_plan(j, c))
        _call(lib.skew_assembly_launch, [P] * 4 + [I] * (len(args) - 4), *args)
        return out
    return run


def k5_launcher(lib: ctypes.CDLL):
    def run(x, f, win, tail, hop):
        z, block = x.shape
        rows, taps = f.shape[1:]
        emit = torch.empty((z, rows, hop), device=x.device)
        new_tail = torch.empty((z, rows, block - hop), device=x.device)
        _call(lib.output_filter_launch, [P] * 6 + [I] * 5, x.data_ptr(), f.data_ptr(),
              win.data_ptr(), tail.data_ptr(), emit.data_ptr(), new_tail.data_ptr(),
              z, rows, taps, block, hop)
        return emit, new_tail
    return run


def k11_launcher(lib: ctypes.CDLL):
    def run(x, f):
        z, block = x.shape
        rows, taps = f.shape[1:]
        out = torch.empty((z, rows, block), device=x.device)
        _call(lib.circular_filter_launch, [P] * 3 + [I] * 4, x.data_ptr(), f.data_ptr(),
              out.data_ptr(), z, rows, taps, block)
        return out
    return run


def time_ms(fn, flush: torch.Tensor | None, spin: bool = True) -> float:
    """Mean CUDA-event time of ``fn`` over LAUNCHES launches, the L2 flushed
    before each (``flush`` read) or warm (None); with ``spin`` the card
    spins (chip_smoke.py's SPIN_CYCLES) while the host enqueues the launch,
    so the events time the device alone; without it a launch shorter than
    the host's path times the host."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(LAUNCHES):
        if flush is not None:
            flush.sum()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / LAUNCHES


def stages(label: str, lib: ctypes.CDLL, fn, flush: torch.Tensor) -> None:
    """Mean time per stage kind (ms) over LAUNCHES flushed stamped launches,
    the stamps of each kind a launch, and the blocks' spread in the last."""
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
    starts, ends = stage_blocks(lib)[:2]
    timed = [b for b in range(STAGE_BLOCKS) if starts[b] and ends[b]]
    t0 = min(starts[b] for b in timed)
    span = sorted((ends[b] - starts[b]) * 1e-3 for b in timed)
    end_us = sorted((ends[b] - t0) * 1e-3 for b in timed)
    print(f"{label} stages (ms, mean of {LAUNCHES}; block 0's stamping thread, first to last "
          f"{sum(totals.values()):.5f}): "
          + ", ".join(f"{KINDS.get(k, k)} {v:.5f} ({n_of[k]} stamps)"
                      for k, v in sorted(totals.items())), flush=True)
    print(f"{label} blocks (last launch, us): {len(timed)} blocks, the last starts at "
          f"{(max(starts[b] for b in timed) - t0) * 1e-3:.2f}; a block takes median "
          f"{span[len(span) // 2]:.2f}, max {span[-1]:.2f}; ends median "
          f"{end_us[len(end_us) // 2]:.2f}, last {end_us[-1]:.2f}", flush=True)


def _source(csrc: str, name: str, stage_dir: str) -> tuple[str, bool]:
    """The path of ``name``'s source to build stamped (the first designs'
    written with stamps inserted) and whether it takes the plan."""
    path = os.path.join(csrc, f"{name}.cu")
    with open(path) as f:
        src = f.read()
    planned = "int band" in src
    if "STAGE_STAMP(" not in src:
        src = (_insert_k3_stamps if name == "skew_assembly" else _insert_k5_stamps)(src)
        path = os.path.join(stage_dir, f"first_{name}.cu")
        with open(path, "w") as f:
            f.write(src)
    return path, planned


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose K3, K5 and K11 to time beside this one")
    ap.add_argument("--first-only", action="store_true",
                    help="with --parent: only that tree's kernels (checked, stamped, timed)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    if args.first_only and not args.parent:
        ap.error("--first-only needs --parent")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    stage_dir = os.path.join(_build.BUILD_DIR, "stages")
    os.makedirs(stage_dir, exist_ok=True)
    trees = {}
    if args.parent:
        trees["parent"] = os.path.join(os.path.abspath(args.parent), "apvast_torch", "csrc")
    if not args.first_only:
        trees["this"] = _build.CSRC
    jobs, planned = {}, {}
    for tree, csrc in trees.items():
        for name in ("skew_assembly", "output_filter"):
            stamped, takes_plan = _source(csrc, name, stage_dir)
            planned[tree] = planned.get(tree, False) or takes_plan
            jobs[f"{tree} {name}"] = (os.path.join(csrc, f"{name}.cu"), False, ())
            jobs[f"{tree} {name} stamped"] = (stamped, True, ())
    libs = build(jobs, stage_dir)
    if "this" in trees:  # the wrappers' own libraries, before anything is timed
        _build.build_all(("skew_assembly", "output_filter"))

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dev)

    k3_in = {label: (rnd(4, j * s, c), rnd(4, c, s * j), rnd(4, s, s * j), j)
             for label, (s, j, c) in K3_SHAPES.items()}
    win = rnd(BLOCK).abs()
    x5 = rnd(2, BLOCK)
    k5_in = {label: (x5, rnd(2, rows, TAPS, scale=1e-2), win,
                     rnd(2, rows, BLOCK - HOP, scale=1e-2), HOP)
             for label, rows in K5_SHAPES.items()}
    flush = torch.zeros(64 * 2**20 // 4, device=dev)

    forms = {}  # (kernel, tree) -> function of the inputs
    for tree in trees:
        for suffix in ("", " stamped"):
            k3 = k3_launcher(libs[f"{tree} skew_assembly{suffix}"], planned[tree])
            lib5 = libs[f"{tree} output_filter{suffix}"]
            key = tree + suffix
            forms[("K3 half", key)] = lambda a, b, c, j, k3=k3: k3(a, b, c, j, True)
            forms[("K3 full", key)] = lambda a, b, c, j, k3=k3: k3(a, b, c, j, False)
            forms[("K5", key)] = k5_launcher(lib5)
            forms[("K11", key)] = lambda x, f, w, t, h, k11=k11_launcher(lib5): k11(x, f)
    plain = {"K3 half": lambda a, b, c, j: K.lag_skew_assemble_plain(a, b, c, j, True),
             "K3 full": lambda a, b, c, j: K.lag_skew_assemble_plain(a, b, c, j, False),
             "K5": K.circular_filter_overlap_plain,
             "K11": lambda x, f, w, t, h: K.circular_filter_plain(x, f)}
    inputs = {"K3 half": k3_in, "K3 full": k3_in, "K5": k5_in, "K11": k5_in}
    for (kernel, key), fn in forms.items():
        for label, xs in inputs[kernel].items():
            check(f"{key} {kernel} {label}", fn(*xs), plain[kernel](*xs))

    # The first designs' stages before any new kernel is timed.
    order = [t for t in ("parent", "this") if t in trees]
    for tree in order:
        for kernel in plain:
            xs = inputs[kernel]["north star"]
            stages(f"{tree} {kernel} north star", libs[
                f"{tree} {'skew_assembly' if kernel.startswith('K3') else 'output_filter'} stamped"],
                lambda fn=forms[(kernel, tree + ' stamped')], xs=xs: fn(*xs), flush)

    series = (["parent"] if args.parent else []) + (["this", "this"] if "this" in trees else [])
    series += ["parent"] if args.parent and "this" in trees else []
    runs = [("flushed", flush, True), ("warm", None, True), ("flushed, no spin", flush, False)]
    for kernel in plain:
        for label, xs in inputs[kernel].items():
            for cache, fl, spin in runs:
                if not spin and label != "north star":
                    continue
                times = [(tree, time_ms(lambda fn=forms[(kernel, tree)], xs=xs: fn(*xs), fl, spin))
                         for tree in series]
                print(f"{kernel} {label}, {cache}: "
                      + ", ".join(f"{tree} {ms:.5f}" for tree, ms in times) + " ms", flush=True)
        # Through the wrapper, as the hop and chip_smoke.py call it.
        if "this" in trees:
            xs = inputs[kernel]["north star"]
            wrapper = {"K3 half": lambda a, b, c, j: K.lag_skew_assemble(a, b, c, j, True),
                       "K3 full": lambda a, b, c, j: K.lag_skew_assemble(a, b, c, j),
                       "K5": K.circular_filter_overlap,
                       "K11": lambda x, f, w, t, h: K.circular_filter(x, f)}[kernel]
            print(f"{kernel} north star, this tree's wrapper, flushed: "
                  + ", ".join(f"{'spin' if spin else 'no spin'} "
                              f"{time_ms(lambda: wrapper(*xs), flush, spin):.5f}"
                              for spin in (True, False)) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
