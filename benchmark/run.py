"""The benchmark of ``apvast_torch``, the PyTorch and CUDA port of AP-VAST,
on one or more NVIDIA cards.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json``: the graphed production hop of the
cell's configuration over its streams, back to back, for ``--seconds``
seconds; then the float64 reference judges hops drawn from the seed
(``harness/judge.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read by
``benchmark/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``compared`` (each compared number and its limit,
also the last lines of standard error).

``--control tf32`` runs the program with TF32 matrix products, the
precision below the configuration's, and ``--control <fault>`` plants one
of ``harness/faults.py``'s faults underneath the timed path, to read the
comparison's upper end at a cell's own size; the benchmark's own runs
never pass it. Exits non-zero, printing no
result, without a card, with fewer cards than the cell asks for, or if
JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "apvast_tpu")


def loaded_forbidden() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device, control: str | None = None,
             t_process: float | None = None) -> dict:
    """One run of ``cell`` on ``device``: the result's fields (without
    printing). ``control`` is None, "tf32" or the name of a fault in
    ``harness/faults.py``, planted before the warmup and taken out once
    the window has closed."""
    import torch

    from harness import drive, faults, judge, spec, trace as tr

    t_process = T_PROCESS if t_process is None else t_process
    tf32 = control == "tf32"
    if control not in (None, "tf32", *faults.PLANT):
        raise ValueError(f"unknown control {control!r}")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cuda = device.type == "cuda"
    undo = faults.BEFORE_BUILD[control](cell) if control in faults.BEFORE_BUILD else None
    t_build = time.perf_counter()
    try:
        built = drive.build(cell, seed, device, graph=cuda)
    except BaseException:
        if undo is not None:
            undo()
        raise
    built.setup["before_build_s"] = t_build - t_process
    if control in faults.AFTER_BUILD:
        undo = faults.AFTER_BUILD[control](built)
    span = int(cell.traffic.get("judge_hops", 600))
    judged = drive.judged_hops(seed, span)
    try:
        rec = drive.run(built, device, seconds, trace, judged, t_process)
    finally:
        if undo is not None:
            undo()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    prof, rec["prof"] = rec["prof"], None
    rirs, progs = built.rirs, built.progs.numpy()
    c = built.model.config
    dims = dict(c.__dict__, hop=c.hop, fir_fft_size=c.fir_fft_size, jl=c.jl,
                subspace_rank=c.subspace_rank)
    del built
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    record = dict(rec, dims=dims, peaks=spec.peaks())
    dev_info = dict(platform="gpu" if cuda else device.type,
                    kind=torch.cuda.get_device_name(device) if cuda else "cpu",
                    count=1, memory_peak_bytes=int(peak))
    breakdown = None
    if trace:
        if prof is None:
            raise RuntimeError("the window closed before the profiled slice began")
        seen = tr.read(prof)
        record["profile"] = dict(seen, hops=rec["prof_hops"], window_s=rec["prof_window_s"])
        dev_info.update(busy_s=seen["busy_s"], window_s=rec["prof_window_s"])
        breakdown = dict(device_ops=seen["device_ops"], idle_gaps=seen["idle_gaps"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    t_judge = time.perf_counter()
    verdict = judge.judge(cell.config, rirs, progs, rec, judged, device)
    verdict["seconds"] = time.perf_counter() - t_judge
    return dict(record=record, metrics=metrics, device=dev_info, breakdown=breakdown,
                verdict=verdict)


def result_line(out: dict) -> dict:
    """The result's last line from :func:`run_cell`'s fields: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, and last ``compared``."""
    rec, verdict = out["record"], out["verdict"]
    result = dict(correct=verdict["correct"], attempted=rec["attempted"], failed=rec["failed"],
                  metrics=out["metrics"], device=out["device"])
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["compared"] = verdict["compared"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="tf32, or a fault of harness/faults.py's BEFORE_BUILD (the "
                         "comparison's upper end)")
    args = ap.parse_args(argv)

    import torch

    from harness import faults, spec

    if args.control not in (None, "tf32", *faults.BEFORE_BUILD):
        ap.error(f"--control takes tf32 or one of {sorted(faults.BEFORE_BUILD)}")

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no CUDA card, or fewer than the {cell.chips} this cell asks for: the benchmark "
              "runs on the card only", file=sys.stderr)
        return 2
    import apvast_torch

    if not os.path.abspath(apvast_torch.__file__).startswith(ROOT + os.sep):
        print(f"apvast_torch comes from {apvast_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, args.control)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"loaded: {forbidden}; the benchmark runs the port alone", file=sys.stderr)
        return 3
    rec, verdict = out["record"], out["verdict"]
    hop_ms = sorted(1e3 * s for s in rec["hop_s"])
    print(f"[bench] {cell.name} seed {args.seed}: {rec['hops']} hops of {rec['streams']} "
          f"stream(s) in {rec['window_s']:.4f} s ({len(hop_ms)} timed, "
          f"{sum(rec['rebuilt'])} rebuild hops), setup {rec['setup_s']:.4f} s, "
          f"hop ms min {hop_ms[0]:.4f} median {hop_ms[len(hop_ms) // 2]:.4f} "
          f"max {hop_ms[-1]:.4f}; card {power_limit()}; control {args.control}; setup parts "
          f"{ {k: round(v, 3) for k, v in rec['setup_parts'].items()} }",
          file=sys.stderr)
    print(f"[bench] judged hops {verdict['judged']} of {verdict['streams']} stream(s); "
          f"in {verdict['seconds']:.2f} s; "
          f"numbers {verdict['numbers']}; process {time.perf_counter() - T_PROCESS:.1f} s",
          file=sys.stderr)
    result = result_line(out)
    compared = result["compared"]
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
