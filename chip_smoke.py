"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # phases 0-3, needs one CUDA card
    python3 chip_smoke.py --profile  # also phase 4: a torch.profiler
                                     # breakdown of 8 steady-state hops

Phase 0  environment: card name and power limit, torch/CUDA versions,
         TF32 off for matmuls and cuDNN.
Phase 1  build: every kernel of apvast_torch/csrc with nvcc (one process
         per source, all at once).
Phase 2  each kernel against its plain PyTorch version on the card, at the
         north-star shapes and at ragged small shapes:
         max|kernel - plain| / max|plain| <= 1e-4 (fp32 sums taken in
         another order). Times by CUDA events after warm-up, with the 50 MB
         L2 flushed (a 64 MB read) before every launch; the bound is the
         larger of bytes over 3.35 TB/s and fp32 operations over
         67 TFLOP/s (H100 SXM published peaks).
Phase 4  (``--profile``) device time by kernel and by stage over 8
         steady-state hops, and the device's idle share.
Phase 3  the slice's main path: ``ApVast`` on ``scale_scene(16)`` under
         ``slice_overrides()`` (production config with the exact GEVD
         solver) for 48 hops on the card, input and initial noise from a
         seed. Checks every kernel ran once per hop, ``silenced == 0``,
         finite outputs of the right shapes, and agreement of the first 8
         hops with the same run on the CPU (plain versions): statistics
         (R, r) to 1e-4 of their scale, target feeds to 1e-4 and loudspeaker
         feeds to 5e-2 of the signal scale (the exact GEVD amplifies
         summation-order noise of near-degenerate pencils).

The last line of output is ``{"ok": true, "device": {...}}``; any failure
exits non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TOL_KERNEL = 1e-4
TOL_STATS = 1e-4
TOL_TARGET = 1e-4
TOL_FEEDS = 5e-2
HOPS = 48
CPU_HOPS = 8
SEED = 20261016


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, L2 flushed
    before each by reading a buffer larger than it (a read leaves no dirty
    lines whose write-back would land inside the timed launch)."""
    for _ in range(3):
        fn()
    total = 0.0
    events = []
    for _ in range(iters):
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    for start, end in events:
        total += start.elapsed_time(end)
    return total / iters


def _rel(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max abs difference, that over max |b|)."""
    diff = (a.double() - b.double()).abs().max().item()
    scale = b.double().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def _check(name: str, rel: float, tol: float) -> None:
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {tol:.0e}")


def phase2(scene, dev, card):
    from apvast_torch.engine.plan import build_plan
    from apvast_torch.ops import kernels as K

    cfg = scene.config
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float32).to(dev)

    plan = build_plan(cfg, scene.rir_a, scene.rir_b, dev)
    m, s, j, hop, block = (
        cfg.num_mics, cfg.num_srcs, cfg.filter_length, cfg.hop, cfg.block_size
    )
    v = cfg.num_solutions
    F = torch.nn.functional
    flush = torch.zeros(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    results = []

    # K1 streaming convolution: segments (2, fir_fft_size), rows 2MS+M.
    seg = rnd(2, cfg.fir_fft_size) * 1e-1
    kern = plan.conv_kernels
    taps, rows = kern.shape[-1], kern.shape[1]
    hist = seg.shape[-1] - hop
    conv_w = kern.flip(-1).reshape(2 * rows, 1, taps)
    conv_in = seg[None, :, hist - taps + 1 :].contiguous()

    # K2 lag correlations: (4, M, S+1, N-1) with the target row, J lags.
    x2 = rnd(4, m, s + 1, cfg.statistics_buffer_length - 1) * 1e-3
    n2 = x2.shape[-1]
    k2 = n2 - j + 1
    c0_in = x2.permute(2, 0, 1, 3).reshape(s + 1, 4 * m, n2).contiguous()
    c0_w = x2[..., :k2].permute(0, 2, 1, 3).reshape(4 * (s + 1), m, k2).contiguous()

    # K3 skew assembly: lhsT (4, J*S, 2M), rhs (4, 2M, S*J), c0 (4, S, S*J).
    lhs3, rhs3, c03 = rnd(4, j * s, 2 * m), rnd(4, 2 * m, s * j), rnd(4, s, s * j)

    # K5 output filter: windowed block (2, block), V*S filter rows.
    x5 = (plan.window * rnd(2, block)).contiguous()
    f5, t5 = rnd(2, v * s, j) * 1e-2, rnd(2, v * s, block - hop) * 1e-2
    ext5 = torch.cat([x5[:, block - (j - 1) :], x5], -1)[None].contiguous()
    w5 = f5.flip(-1).reshape(2 * v * s, 1, j).contiguous()

    cases = [
        dict(
            name="streaming_conv", route="cuda",
            source="apvast_torch/csrc/streaming_conv.cu",
            replaces="apvast_tpu/ops/pallas/streaming_conv.py:53",
            kernel=lambda: K.streaming_conv(seg, kern, hop),
            plain=lambda: K.streaming_conv_plain(seg, kern, hop),
            library=lambda: F.conv1d(conv_in, conv_w, groups=2),
            flops=2 * 2 * rows * taps * hop,
            bytes=4 * (seg.numel() + kern.numel() + 2 * rows * hop),
            ragged=[
                (lambda a, b: K.streaming_conv(a, b, 50),
                 lambda a, b: K.streaming_conv_plain(a, b, 50),
                 (rnd(2, 300), rnd(2, 37, 77))),
            ],
        ),
        dict(
            name="lag_corr", route="cuda",
            source="apvast_torch/csrc/lag_corr.cu",
            replaces="apvast_tpu/ops/pallas/lag_corr.py:60",
            kernel=lambda: K.lag_corr(x2, j),
            plain=lambda: K.lag_corr_plain(x2, j),
            library=lambda: F.conv1d(c0_in, c0_w, groups=4),
            flops=2 * 4 * m * (s + 1) ** 2 * j * k2,
            bytes=4 * (x2.numel() + 4 * (s + 1) ** 2 * j),
            ragged=[
                (lambda a: K.lag_corr(a, 9), lambda a: K.lag_corr_plain(a, 9),
                 (rnd(4, 3, 5, 70),)),
                (lambda a: K.lag_corr(a, 40), lambda a: K.lag_corr_plain(a, 40),
                 (rnd(4, 2, 33, 120),)),
            ],
        ),
        dict(
            name="skew_assembly", route="cuda",
            source="apvast_torch/csrc/skew_assembly.cu",
            replaces="apvast_tpu/ops/pallas/skew_assembly.py:118",
            kernel=lambda: K.lag_skew_assemble(lhs3, rhs3, c03, j),
            plain=lambda: K.lag_skew_assemble_plain(lhs3, rhs3, c03, j),
            library=None,
            flops=2 * 4 * (j * s) * (2 * m) * (s * j),
            bytes=4 * (lhs3.numel() + rhs3.numel() + c03.numel() + 4 * s * j * s * j),
            ragged=[
                (lambda a, b, c: K.lag_skew_assemble(a, b, c, 9),
                 lambda a, b, c: K.lag_skew_assemble_plain(a, b, c, 9),
                 (rnd(4, 9 * 5, 6), rnd(4, 6, 5 * 9), rnd(4, 5, 5 * 9))),
            ],
        ),
        dict(
            name="output_filter", route="cuda",
            source="apvast_torch/csrc/output_filter.cu",
            replaces="apvast_tpu/ops/pallas/output_filter.py:72",
            kernel=lambda: K.circular_filter_overlap(x5, f5, plan.window, t5, hop),
            plain=lambda: K.circular_filter_overlap_plain(x5, f5, plan.window, t5, hop),
            library=lambda: F.conv1d(ext5, w5, groups=2),
            flops=2 * 2 * v * s * j * block,
            bytes=4 * (x5.numel() + f5.numel() + block + t5.numel()
                       + 2 * v * s * hop + t5.numel()),
            ragged=[
                (lambda a, b, w, t: K.circular_filter_overlap(a, b, w, t, 30),
                 lambda a, b, w, t: K.circular_filter_overlap_plain(a, b, w, t, 30),
                 (rnd(2, 100), rnd(2, 37, 9), rnd(100), rnd(2, 37, 70))),
                (lambda a, b, w, t: K.circular_filter_overlap(a, b, w, t, 60),
                 lambda a, b, w, t: K.circular_filter_overlap_plain(a, b, w, t, 60),
                 (rnd(2, 100), rnd(2, 37, 9), rnd(100), rnd(2, 37, 40))),
            ],
        ),
    ]

    for c in cases:
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs = [_rel(a, b) for a, b in zip(got, want)]
        max_abs = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        _check(c["name"] + " (north-star shape)", rel, TOL_KERNEL)
        for kfn, pfn, args in c["ragged"]:
            rg, rw = kfn(*args), pfn(*args)
            rg = rg if isinstance(rg, tuple) else (rg,)
            rw = rw if isinstance(rw, tuple) else (rw,)
            shapes = [tuple(a.shape) for a in args]
            for a, b in zip(rg, rw):
                _check(f"{c['name']} (ragged {shapes})", _rel(a, b)[1], TOL_KERNEL)
        kernel_ms = _time_ms(c["kernel"], 50, flush)
        plain_ms = _time_ms(c["plain"], 10, flush)
        library_ms = _time_ms(c["library"], 50, flush) if c["library"] else None
        t_ops = c["flops"] / PEAK_FP32_FLOPS * 1e3
        t_bytes = c["bytes"] / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(
            f"[phase 2] {c['name']}: rel_err={rel:.3e} max_abs_err={max_abs:.3e} "
            f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
            f"library_ms={library_ms if library_ms is None else f'{library_ms:.5f}'} "
            f"bound_us={bound_ms * 1e3:.2f} ({bound_by}) "
            f"roofline_share={bound_ms / kernel_ms:.3f} card={card}",
            flush=True,
        )
        results.append(dict(
            name=c["name"], route=c["route"], source=c["source"],
            replaces=c["replaces"], launches=0, max_abs_err=max_abs,
            ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
        ))
    return results


def _noise(cfg, rng):
    m, s, block = cfg.num_mics, cfg.num_srcs, cfg.block_size
    return (
        1e-3 * rng.standard_normal((4, m, s, block)),
        1e-3 * rng.standard_normal((2, m, block)),
    )


def _model(scene, device, noise):
    from apvast_torch import ApVast, slice_overrides

    c = scene.config
    return ApVast(
        c.block_size, scene.rir_a, scene.rir_b, c.filter_length,
        c.modeling_delay, c.reference_index_a, c.reference_index_b,
        c.num_eigenvectors, c.mu, c.statistics_buffer_length,
        sampling_rate=c.sampling_rate, perceptual=c.perceptual,
        device=device, response_noise=noise, **slice_overrides(),
    )


def phase3(scene, dev, card, results):
    from apvast_torch.engine import hop_statistics
    from apvast_torch.ops import kernels as K

    rng = np.random.default_rng(SEED)
    noise = _noise(scene.config, rng)
    model = _model(scene, dev, noise)
    cfg = model.config
    sig = rng.standard_normal((2, HOPS * cfg.hop)).astype(np.float32)
    hops_a = torch.as_tensor(sig[0]).reshape(HOPS, cfg.hop)
    hops_b = torch.as_tensor(sig[1]).reshape(HOPS, cfg.hop)
    hops_a_dev, hops_b_dev = hops_a.to(dev), hops_b.to(dev)
    v, s = cfg.num_solutions, cfg.num_srcs
    torch.cuda.synchronize()

    K.reset_launch_counts()
    first, state8 = [], None
    t_first = time.perf_counter()
    for i in range(CPU_HOPS):
        first.append(model.process_input_buffers(hops_a_dev[i], hops_b_dev[i]))
    state8 = model.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = None
    for i in range(CPU_HOPS, HOPS):
        last = model.process_input_buffers(hops_a_dev[i], hops_b_dev[i])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = K.launch_counts()
    print(f"[phase 3] launches over {HOPS} hops: {counts}", flush=True)
    for name, n in counts.items():
        if n != HOPS:
            raise AssertionError(f"{name} launched {n} times in {HOPS} hops, want {HOPS}")
    for r in results:
        r["launches"] = counts[r["name"]]
    silenced = int(model.silenced.item())
    if silenced != 0:
        raise AssertionError(f"silenced = {silenced}")
    for out in (*first, last):
        for t, shape in zip(out, [(v, cfg.hop, s)] * 4):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise AssertionError(f"bad output: shape {tuple(t.shape)}")
    ms_hop = (t1 - t0) / (HOPS - CPU_HOPS) * 1e3
    print(
        f"[phase 3] scale_scene(16) slice config: {HOPS} hops, silenced=0, "
        f"first {CPU_HOPS} hops {(t0 - t_first) * 1e3 / CPU_HOPS:.3f} ms/hop, "
        f"steady state {ms_hop:.3f} ms/hop over hops {CPU_HOPS + 1}-{HOPS} "
        f"(host clock, synchronized) card={card}",
        flush=True,
    )

    # The same first hops through the port on the CPU (plain versions).
    t2 = time.perf_counter()
    cpu = _model(scene, "cpu", noise)
    cpu_first = [
        cpu.process_input_buffers(hops_a[i], hops_b[i]) for i in range(CPU_HOPS)
    ]
    r_gpu = hop_statistics(cfg, state8.wresp_stat, state8.wtarget_stat)
    r_cpu = hop_statistics(cfg, cpu.state.wresp_stat, cpu.state.wtarget_stat)
    for name, a, b in zip(("R", "r"), r_gpu, r_cpu):
        rel = _rel(a.cpu(), b)[1]
        print(f"[phase 3] hop {CPU_HOPS} statistics {name}: rel_err={rel:.3e}", flush=True)
        _check(f"statistics {name}", rel, TOL_STATS)
    for f, name in enumerate(("out_a", "out_b", "out_a_t", "out_b_t")):
        g = torch.stack([o[f] for o in first]).cpu()
        c = torch.stack([o[f] for o in cpu_first])
        rel = _rel(g, c)[1]
        per_hop = [f"{_rel(g[i], c[i])[1]:.1e}" for i in range(CPU_HOPS)]
        print(f"[phase 3] {name} vs CPU, hops 1-{CPU_HOPS}: rel_err={rel:.3e} "
              f"(per hop {per_hop})", flush=True)
        _check(f"{name} vs CPU", rel, TOL_TARGET if name.endswith("_t") else TOL_FEEDS)
    print(f"[phase 3] CPU comparison took {time.perf_counter() - t2:.1f} s", flush=True)
    return model, hops_a_dev, hops_b_dev, ms_hop


def phase4(model, hops_a, hops_b, card, wall_ms_hop):
    """Device time by kernel over 8 steady-state hops, and the device's
    idle share against the unprofiled steady-state hop time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            model.process_input_buffers(hops_a[i], hops_b[i])
        torch.cuda.synchronize()
    rows = sorted(
        (
            (e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / n / 1e3
    print(f"[phase 4] kernel time {busy_ms:.3f} ms/hop over {n} hops "
          f"({sum(r[2] for r in rows) // n} kernels/hop); idle share "
          f"{1 - busy_ms / wall_ms_hop:.3f} of the {wall_ms_hop:.3f} ms/hop "
          f"steady state; card={card}", flush=True)
    # Device time by stage: the kernels each library op launched, and the
    # four port kernels by name; "other" is the elementwise rest.
    averages = prof.key_averages()

    def op_ms(*keys):
        return sum(e.device_time_total for e in averages if e.key in keys) / n / 1e3

    stages = {
        "eigh (torch.linalg.eigh)": op_ms("aten::_linalg_eigh"),
        "Cholesky (linalg.cholesky_ex)": op_ms("aten::linalg_cholesky_ex"),
        "triangular solves": op_ms("aten::linalg_solve_triangular"),
        "matmuls (aten::mm, aten::bmm)": op_ms("aten::mm", "aten::bmm"),
    }
    for name in ("streaming_conv", "lag_corr", "skew_assembly", "output_filter"):
        stages[f"kernel {name}"] = sum(
            r[0] for r in rows if f"{name}_kernel" in r[1]
        ) / n / 1e3
    stages["other (elementwise ops, copies, reductions)"] = busy_ms - sum(stages.values())
    for name, ms in stages.items():
        print(f"[phase 4] stage {ms:8.4f} ms/hop  {ms / busy_ms:6.1%}  {name}", flush=True)
    for dev_us, key, count in rows[:25]:
        print(f"[phase 4]   {dev_us / n / 1e3:8.4f} ms/hop  {count / n:5.1f}/hop  {key[:90]}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 4, a torch.profiler breakdown of 8 hops")
    args = ap.parse_args()

    # ---- phase 0: environment ------------------------------------------
    if not torch.cuda.is_available():
        print("[phase 0] no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 1
    card = _nvidia_smi()
    print(f"[phase 0] {card}", flush=True)
    print(f"[phase 0] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[phase 0] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)

    from apvast_torch.ops.kernels import _build
    from apvast_torch.utils.scenes import scale_scene

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[phase 1] built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(per source: { {k: round(v[0], 1) for k, v in built.items()} })", flush=True)
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[phase 1] {name}: {line.strip()}", flush=True)

    scene = scale_scene(16)

    # ---- phase 2: kernels against their plain versions -----------------
    results = phase2(scene, dev, card)

    # ---- phase 3: the main path ----------------------------------------
    model, hops_a, hops_b, ms_hop = phase3(scene, dev, card, results)

    if args.profile:
        phase4(model, hops_a, hops_b, card, ms_hop)

    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
