"""Check and time kernels K1 (streaming convolution) and K6 (dense framed
covariance) against their plain versions, a float64 oracle, their one-call
yardsticks and, optionally, an earlier tree's K1 and K6, on one CUDA card,
in one process.

    python3 tools/k1_k6_first_design.py [--parent DIR]

Shapes: K1 at the north star (segments (2, 4096), the scene's kernels
(2, 561, 2400), hop 800) and the ragged (2, 300) x (2, 37, 77), hop 50; K6
at the north star (buffers (4, 17, 16, 999), targets (2, 17, 950), J = 50),
at SJ = 1600 (S = 32) and the ragged (4, 3, 4, 96), J = 8. Every form is
held to its plain version (max |x - plain| / max |plain|) and to a float64
oracle (the plain version in float64 on the card), printed beside the plain
float32 version's own error against that oracle.

``--parent DIR``: an earlier commit unpacked into a directory that
``.gitignore`` lists, whose ``apvast_torch/csrc/streaming_conv.cu`` and
``statistics.cu`` are built here with the port's nvcc flags and timed
beside this tree's, e.g. the first designs of PRs 1-7::

    git archive 91b054a | tar -x -C .archive_check/parent

Their C entry points take the same arguments as this tree's. Times are
CUDA-event means with the L2 flushed before every launch, in the order
parent, this tree, this tree, parent. Prints the ptxas lines of both
kernels and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from apvast_torch.engine.plan import build_plan  # noqa: E402
from apvast_torch.ops import kernels as K  # noqa: E402
from apvast_torch.ops.framing import framed_statistics  # noqa: E402
from apvast_torch.ops.kernels import _build  # noqa: E402
from apvast_torch.utils.scenes import scale_scene  # noqa: E402


def time_ms(fn, flush: torch.Tensor, iters: int = 50) -> float:
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


def parent_kernels(parent: str):
    """K1 and K6 of ``parent``'s csrc, built with the port's flags, as
    functions of the wrappers' arguments."""
    libs = {}
    for name in ("streaming_conv", "statistics"):
        src = os.path.join(parent, "apvast_torch", "csrc", f"{name}.cu")
        out = os.path.join(parent, f"{name}_parent.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        libs[name] = ctypes.CDLL(out)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k1(seg, kern, hop):
        z, seg_len = seg.shape
        _, rows, taps = kern.shape
        out = torch.empty((z, rows, hop), device=seg.device)
        fn = libs["streaming_conv"].streaming_conv_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        if fn(seg.data_ptr(), kern.data_ptr(), out.data_ptr(), z, seg_len, rows, taps, hop,
              stream()) != 0:
            raise RuntimeError("parent streaming_conv_launch failed")
        return out

    def k6(buf, tgt, j):
        p4, m, s, n = buf.shape
        r = torch.empty((p4, s * j, s * j), device=buf.device)
        rc = torch.empty((p4, s * j, 2), device=buf.device)
        fn = libs["statistics"].statistics_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        if fn(buf.data_ptr(), tgt.data_ptr(), r.data_ptr(), rc.data_ptr(), p4, m, s, n, j,
              stream()) != 0:
            raise RuntimeError("parent statistics_launch failed")
        return r, rc

    return k1, k6


def rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref.double()).abs().max() / ref.double().abs().max())


def check(label: str, forms: dict, plain, args) -> None:
    """Each form against the plain version and the float64 oracle, per output."""
    want = plain(*args)
    oracle = plain(*(a.double() for a in args[:2]), *args[2:])
    want, oracle = (w if isinstance(w, tuple) else (w,) for w in (want, oracle))
    own = [rel(w, o) for w, o in zip(want, oracle)]
    for name, fn in forms.items():
        got = fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        print(f"{label} {name}: against plain "
              f"{[f'{rel(x, w):.3e}' for x, w in zip(got, want)]}, against float64 "
              f"{[f'{rel(x, o):.3e}' for x, o in zip(got, oracle)]} (plain float32's own: "
              f"{[f'{e:.3e}' for e in own]})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree whose K1 and K6 to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for name, (secs, log) in _build.build_all(("streaming_conv", "statistics")).items():
        print(f"built {name} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "Function properties for" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    parent = parent_kernels(args.parent) if args.parent else None

    scene = scale_scene(16)
    cfg = scene.config
    plan = build_plan(cfg, scene.rir_a, scene.rir_b, dev)
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g).to(dev)  # noqa: E731
    flush = torch.zeros(64 * 2**20 // 4, device=dev)

    hop, j, m, s = cfg.hop, cfg.filter_length, cfg.num_mics, cfg.num_srcs
    seg = rnd(2, cfg.fir_fft_size) * 1e-1
    kern = plan.conv_kernels
    n6 = cfg.statistics_buffer_length - 1
    buf6, tgt6 = rnd(4, m, s, n6) * 1e-3, rnd(2, m, n6 - j + 1) * 1e-3
    buf6w = rnd(4, m, 2 * s, n6) * 1e-3

    k1 = {"k1": K.streaming_conv} | ({"parent": parent[0]} if parent else {})
    k6 = {"k6": K.covariance} | ({"parent": parent[1]} if parent else {})
    check("K1 north star", k1, K.streaming_conv_plain, (seg, kern, hop))
    check("K1 ragged (2, 300) x (2, 37, 77)", k1, K.streaming_conv_plain,
          (rnd(2, 300), rnd(2, 37, 77), 50))
    check("K6 north star", k6, K.covariance_plain, (buf6, tgt6, j))
    check("K6 SJ = 1600", k6, K.covariance_plain, (buf6w, tgt6, j))
    check("K6 ragged (4, 3, 4, 96), J = 8", k6, K.covariance_plain,
          (rnd(4, 3, 4, 96), rnd(2, 3, 89), 8))

    taps = kern.shape[-1]
    hist = seg.shape[-1] - hop
    cases = {
        "K1": ({"k1": lambda: K.streaming_conv(seg, kern, hop)}
               | ({"parent": lambda: parent[0](seg, kern, hop)} if parent else {}),
               {"cublas matmul": lambda: kern @ seg.unfold(-1, hop, 1)[:, hist - taps + 1:
                                                                       hist + 1].flip(1)}),
        "K6": ({"k6": lambda: K.covariance(buf6, tgt6, j)}
               | ({"parent": lambda: parent[1](buf6, tgt6, j)} if parent else {}),
               {"unfold + einsum": lambda: framed_statistics(buf6, tgt6, j)}),
        "K6 SJ = 1600": ({"k6": lambda: K.covariance(buf6w, tgt6, j)}
                         | ({"parent": lambda: parent[1](buf6w, tgt6, j)} if parent else {}),
                         {}),
    }
    for label, (forms, yardsticks) in cases.items():
        this = next(iter(forms))
        order = ["parent", this, this, "parent"] if parent else [this, this]
        times: dict[str, list[float]] = {}
        for name in order:
            times.setdefault(name, []).append(time_ms(forms[name], flush))
        for name, fn in yardsticks.items():
            times[name] = [time_ms(fn, flush)]
        print(f"{label} ms per call: { {k: [round(t, 5) for t in v] for k, v in times.items()} }",
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
