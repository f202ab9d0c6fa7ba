"""Check and time the tracking solver's Rayleigh-Ritz kernel
(``csrc/tracked_rr.cu``: the solve before K4 and the coordinates after it)
on one CUDA card, split the solve into its stages, and count the kernels
one graphed hop launches.

    python3 tools/tracked_rr_stages.py [--zones 2,16,32] [--hop-launches]
                                       [--parent DIR]

Shapes: the production tracker's, (z, 128, 128) pencils and k = 64, at
z = 2 (one stream), 16 and 32 (8 and 16 streams). Inputs: random SPD
pencils with a 1e-6 asymmetric part (the raw projections s^T A s are not
exactly symmetric), each zone scaled differently.

Checks, before any timing: h, y and libar against the plain version on the
card (max |x - plain| / max |plain| <= 1e-4) and, per output, within twice
the plain float32 version's own distance from a float64 evaluation of the
chain; the coordinates against their plain version (1e-4); two launches
bit for bit; a zone with a non-PD bbar and a zone with a NaN entry all NaN,
the others finite. Every check is printed; the script times and splits the
kernel all the same, and exits 1 at the end if a check failed.

Times (CUDA events, the 50 MB L2 flushed before each launch, the card
spinning while the host enqueues it: chip_smoke.py's SPIN_CYCLES, and
CHAIN_SPIN_CYCLES before the torch chain's ~300 launches): the kernel, the
coordinates, and the stretch of the hop they replace (solve, K4 at 2
sweeps, coordinates) as kernels and as the torch chain, eager and replayed
from a CUDA graph as the hop runs it.

Stages: ``csrc/tracked_rr.cu`` built again (into ``apvast_torch/_build/
stages/``) with ``%globaltimer`` stamps at its ``STAGE_STAMP`` hooks
(tools/k9_k10a_stages.py's header), read by thread 0 of block 0; printed
as means over 50 launches per stage kind. chol_warp.cuh's own stamps
inside a factorization are counted in the factorization they belong to.

``--hop-launches``: the kernels of one graphed ``ns16-prod-x1`` hop (the
benchmark's cell, seed 2147483999), counted by torch.profiler hop by hop
over 40 hops and printed per rebuild branch; with ``--parent DIR`` (an
earlier tree unpacked into a directory that ``.gitignore`` lists, e.g.
``git archive HEAD~1 | tar -x -C .archive_check/parent``) that tree's
count too, each tree in its own process.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

N, K = 128, 64
TOL = 1e-4
TOL_ORACLE_RATIO = 2.0
LAUNCHES = 50
SPIN_CYCLES = 200_000  # chip_smoke.py's: ~0.1 ms, covers one wrapper's host path
CHAIN_SPIN_CYCLES = 8_000_000  # ~4 ms: covers the torch chain's ~300 launches
CHOL_WARP_KINDS = (9, 10, 11)  # stamps inside chol_warp.cuh's factor
KINDS = {1: "load, sym, jitter", 2: "pencil factor", 3: "pencil inverse (merge tree)",
         4: "libar out, transpose, wbar = libar abar libar^T",
         5: "Gram matrices (y^T y) and jitter", 6: "Gram factor",
         7: "y <- y L^-T (row solves)", 8: "wbar y", 12: "h = sym(y^T wbar y)", 13: "store"}
HOP_SEED = 2147483999
HOPS = 40


def pencils(z: int, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    scale = torch.logspace(-2, 2, z, dtype=torch.float64)[:, None, None]

    def spd(load):
        x = torch.randn((z, N, N), generator=g, dtype=torch.float64)
        m = x @ x.transpose(1, 2) / N + load * torch.eye(N, dtype=torch.float64)
        return (scale * (m + 1e-6 * torch.randn((z, N, N), generator=g, dtype=torch.float64)))

    return spd(0.0).float().to(dev), spd(0.2).float().to(dev)


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def check(dev) -> list[str]:
    """The checks of the module docstring; returns the failures."""
    from apvast_torch.ops import kernels as K_

    failures = []

    for z in (2, 16, 32):
        a, b = pencils(z, z, dev)
        got = K_.tracked_rr(a, b, K)
        plain = K_.tracked_rr_plain(a, b, K)
        oracle = K_.tracked_rr_plain(a.double(), b.double(), K)
        torch.cuda.synchronize()
        for name, x, p, o in zip(("h", "y", "libar"), got, plain, oracle):
            r_plain, r_x, r_p = rel(x, p), rel(x, o), rel(p, o)
            print(f"z={z} {name}: against plain {r_plain:.3e}; against float64 {r_x:.3e} "
                  f"(plain float32 {r_p:.3e})", flush=True)
            if not (r_plain <= TOL and r_x <= TOL_ORACLE_RATIO * r_p):
                failures.append(f"z={z} {name} out of bounds")
        d, v = K_.jacobi_eigh(got[0], 2)
        c, lam = K_.tracked_rr_coords(got[2], got[1], d, v)
        cp, lp = K_.tracked_rr_coords_plain(got[2], got[1], d, v)
        torch.cuda.synchronize()
        print(f"z={z} coordinates: c against plain {rel(c, cp):.3e}, lam equal "
              f"{torch.equal(lam, lp)}", flush=True)
        if not (rel(c, cp) <= TOL and torch.equal(lam, lp)):
            failures.append(f"z={z} coordinates out of bounds")
        again = K_.tracked_rr(a, b, K)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            failures.append(f"z={z}: two launches differ")
    a, b = pencils(4, 5, dev)
    b[1] = -b[1]  # not PD
    a[2, 7, 3] = float("nan")
    got = K_.tracked_rr(a, b, K)
    torch.cuda.synchronize()
    for zone in range(4):
        nan = [bool(torch.isnan(x[zone]).all()) for x in got]
        fin = [bool(torch.isfinite(x[zone]).all()) for x in got]
        print(f"zone {zone}: all NaN {nan}, all finite {fin}", flush=True)
        if (zone in (1, 2) and not all(nan)) or (zone in (0, 3) and not all(fin)):
            failures.append(f"zone {zone}: wrong failure pattern")
    return failures


def time_ms(fn, flush: torch.Tensor, spin: int, iters: int = LAUNCHES) -> float:
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


def graphed(fn):
    """``fn`` captured in a CUDA graph (after a warm call on a side stream);
    returns its replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def timings(dev, zones) -> None:
    from apvast_torch.ops import kernels as K_

    flush = torch.zeros(64 * 2**20 // 4, device=dev)
    for z in zones:
        a, b = pencils(z, 100 + z, dev)

        def fused():
            h, y, libar = K_.tracked_rr(a, b, K)
            d, v = K_.jacobi_eigh(h, 2)
            return K_.tracked_rr_coords(libar, y, d, v)

        def chain():
            h, y, libar = K_.tracked_rr_plain(a, b, K)
            d, v = K_.jacobi_eigh(h, 2)
            return K_.tracked_rr_coords_plain(libar, y, d, v)

        h, y, libar = K_.tracked_rr(a, b, K)
        d, v = K_.jacobi_eigh(h, 2)
        row = {
            "kernel": time_ms(lambda: K_.tracked_rr(a, b, K), flush, SPIN_CYCLES),
            "coords": time_ms(lambda: K_.tracked_rr_coords(libar, y, d, v), flush, SPIN_CYCLES),
            "K4": time_ms(lambda: K_.jacobi_eigh(h, 2), flush, SPIN_CYCLES),
            "stretch kernels": time_ms(fused, flush, SPIN_CYCLES),
            "stretch kernels graphed": time_ms(graphed(fused), flush, SPIN_CYCLES),
            "stretch torch chain": time_ms(chain, flush, CHAIN_SPIN_CYCLES, 20),
            "stretch torch chain graphed": time_ms(graphed(chain), flush, SPIN_CYCLES, 20),
        }
        print(f"z={z} ms: " + ", ".join(f"{k} {v:.5f}" for k, v in row.items()), flush=True)


def stages(dev, zones) -> None:
    from apvast_torch.ops import kernels as K_
    from apvast_torch.ops.kernels import _build
    from k9_k10a_stages import STAMP_HEADER, _call

    out_dir = os.path.join(_build.BUILD_DIR, "stages")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "tracked_rr.cu")) as f:
        src = STAMP_HEADER + f.read()
    path = os.path.join(out_dir, "tracked_rr_stamped.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so, path],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the stamped build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    flush = torch.zeros(64 * 2**20 // 4, device=dev)
    t = (ctypes.c_ulonglong * 256)()
    kind = (ctypes.c_int * 256)()
    count, grid = ctypes.c_int(), (ctypes.c_int * 2)()
    for z in zones:
        a, b = pencils(z, 200 + z, dev)
        h, y, libar = (torch.empty((z, K, K), device=dev), torch.empty((z, N, K), device=dev),
                       torch.empty((z, N, N), device=dev))
        totals: dict[int, float] = {}
        inner: dict[int, float] = {}
        for it in range(LAUNCHES + 3):
            flush.sum()
            lib.stage_reset()
            _call(lib.tracked_rr_launch, [p] * 5 + [i] * 3, a.data_ptr(), b.data_ptr(),
                  h.data_ptr(), y.data_ptr(), libar.data_ptr(), z, N, K)
            if lib.stage_read(t, kind, ctypes.byref(count), grid):
                raise RuntimeError("stage_read failed")
            if count.value > 256:
                raise RuntimeError(f"{count.value} stamps > 256")
            if it < 3:
                continue
            pending = 0.0  # chol_warp's stamps: counted in the next stage of this kernel
            for j in range(1, count.value):
                dt = (t[j] - t[j - 1]) * 1e-6 / LAUNCHES
                if kind[j] in CHOL_WARP_KINDS:
                    pending += dt
                    inner[kind[j]] = inner.get(kind[j], 0.0) + dt
                    continue
                totals[kind[j]] = totals.get(kind[j], 0.0) + dt + pending
                pending = 0.0
        err = max(rel(x, w) for x, w in zip((h, y, libar), K_.tracked_rr_plain(a, b, K)))
        print(f"stages z={z} (ms, mean of {LAUNCHES}, block 0; first to last "
              f"{sum(totals.values()):.5f}; stamped build against plain {err:.3e}): "
              + ", ".join(f"{KINDS[k]} {v:.5f}" for k, v in sorted(totals.items()))
              + "; inside chol_warp's factors: diagonal blocks "
              f"{inner.get(9, 0):.5f}, strips and diagonal inverses {inner.get(10, 0):.5f}, "
              f"trailing updates {inner.get(11, 0):.5f}", flush=True)


def hop_launches(tree: str) -> dict:
    """Run in a fresh process from ``tree``: kernels a graphed ns16-prod-x1
    hop launches, per rebuild branch (mean over the hops of the branch)."""
    code = f"""
import json, os, sys
sys.path[:0] = [os.path.join({tree!r}, "benchmark"), {tree!r}]
os.chdir({tree!r})
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from harness import drive, spec
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
built = drive.build(spec.load_cell("ns16-prod-x1"), {HOP_SEED}, dev, graph=True)
loop = drive.Loop(built, dev)
per = {{"rebuild": [], "plain": []}}
for tau in range({HOPS}):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rebuilt = loop.hop(tau)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset")))
    per["rebuild" if rebuilt else "plain"].append(kernels)
print(json.dumps(per))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        raise RuntimeError(f"hop count in {tree} failed:\n{proc.stderr[-4000:]}")
    per = json.loads(proc.stdout.strip().splitlines()[-1])
    # The first hops build the graph and warm up; count the steady ones.
    return {k: (sorted(set(v)), len(v)) for k, v in per.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--zones", default="2,16,32", help="zone counts to time and split")
    ap.add_argument("--hop-launches", action="store_true",
                    help="count the kernels of one graphed ns16-prod-x1 hop")
    ap.add_argument("--parent", help="an earlier tree whose hop to count beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    from apvast_torch.ops.kernels import _build

    for name, (secs, log) in _build.build_all(("tracked_rr", "jacobi_eigh")).items():
        print(f"built {name} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    zones = [int(x) for x in args.zones.split(",")]
    failures = check(dev)
    timings(dev, zones)
    stages(dev, zones)
    if args.hop_launches:
        trees = {"this": ROOT} | ({"parent": os.path.abspath(args.parent)} if args.parent else {})
        for label, tree in trees.items():
            print(f"hop kernels, {label} tree (distinct counts, hops): {hop_launches(tree)}",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    for failure in failures:
        print(f"FAILED: {failure}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
