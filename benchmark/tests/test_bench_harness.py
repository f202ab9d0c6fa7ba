"""The harness on the CPU: ``BENCHMARK.json`` against the benchmark
format's characters and keys, every name resolving to its files, a new cell taking
new files and entries only, the result's last line, the work counts
against ``chip_smoke.py``'s, and the comparison failing on every fault of
``harness/faults.py`` planted on the CPU. The control (TF32 products) and
the solver's faults in the graphed hop need the card: ``-m cuda``.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import run  # noqa: E402
from harness import faults, spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SEED = 2**31 + 977


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text) -> bool:
    return isinstance(text, str) and 0 < len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in b["paths"])
    assert all(_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(b["paths"][0] + "/")
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_resolves_by_name(cell):
    """Every cell's configuration, traffic, metric readers and work
    counters are files found by name, and the cell reports setup_s, another
    end-to-end metric and a per-layer metric."""
    c = spec.load_cell(cell)
    assert c.streams >= 1 and c.config["scene"] and c.config["limits"]
    names = [m["name"] for m in c.end_to_end + c.per_layer]
    for name in names:
        assert callable(spec.metric_reader(name))
    assert "setup_s" in names and len(c.end_to_end) >= 2 and c.per_layer
    for name in names:
        if name.endswith("_roofline"):
            kernel = {"k1": "streaming_conv", "k2": "lag_corr", "k3": "skew_assembly",
                      "k4": "jacobi_eigh", "k5": "output_filter"}[name.split("_")[0]]
            w = spec.work_counter(kernel)
            ops, nbytes = w.count(_dims(c), c.streams)
            assert ops > 0 and nbytes > 0


def _dims(cell) -> dict:
    from apvast_torch import ApVastConfig, production_overrides

    sc = cell.config["scene"]
    fields = {k: v for k, v in sc.items() if k not in ("num_srcs", "num_mics", "rir_length")}
    cfg = ApVastConfig(rir_length=sc["rir_length"], num_srcs=sc["num_srcs"],
                       num_mics=sc["num_mics"], **(fields | production_overrides()))
    return dict(cfg.__dict__, hop=cfg.hop, fir_fft_size=cfg.fir_fft_size, jl=cfg.jl,
                subspace_rank=cfg.subspace_rank)


def test_new_cell_takes_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell by new files and BENCHMARK.json entries; the
    unchanged harness finds them."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    cfg = json.load(open(os.path.join(BENCH, "configs", "ns16-prod.json")))
    cfg["name"] = "ns24-prod"
    cfg["scene"].update(num_srcs=24, num_mics=25)
    (tmp_path / "benchmark" / "configs" / "ns24-prod.json").write_text(json.dumps(cfg))
    traffic = json.load(open(os.path.join(BENCH, "traffic", "speechlike-x4.json")))
    traffic["streams"] = 2
    (tmp_path / "benchmark" / "traffic" / "speechlike-x2.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "hops_done.py").write_text(
        "def read(record):\n    return record['hops']\n")
    b["configs"].append(dict(name="ns24-prod", source="a test", file="benchmark/configs/ns24-prod.json",
                             reduced=[], why="a test"))
    b["workloads"].append(dict(name="ns24-prod-x2", config="ns24-prod", traffic="speechlike-x2",
                               chips=1, why="a test"))
    b["per_layer"].append(dict(name="hops_done", unit="hops", better="higher",
                               source="program_counter", layer="the device", moves="realtime_x",
                               workloads=["ns24-prod-x2"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import sys; sys.path.insert(0, 'benchmark')\n"
        "from harness import spec\n"
        "c = spec.load_cell('ns24-prod-x2')\n"
        "assert c.streams == 2 and c.config['scene']['num_srcs'] == 24\n"
        "assert [m['name'] for m in c.per_layer][-1] == 'hops_done'\n"
        "assert spec.metric_reader('hops_done')({'hops': 7}) == 7\n"
        "print('found')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "found"


def test_reference_imports_nothing_of_the_program():
    """No file under benchmark/reference imports the port, the JAX package
    or JAX, by its syntax tree."""
    banned = {"apvast_torch", "apvast_tpu", "jax", "jaxlib", "flax"}
    ref = os.path.join(BENCH, "reference")
    files = [f for f in os.listdir(ref) if f.endswith(".py")]
    assert files
    for f in files:
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".", 1)[0] not in banned, f"{f} imports {name}"


def test_work_counts_equal_chip_smoke():
    """K1, K2, K3 and K5's operations and bytes at the north star's shapes
    equal those chip_smoke.py's _stream_cases counts (the peaks differ by
    design: 495 TFLOP/s here)."""
    import chip_smoke

    cell = spec.load_cell("ns16-prod-x8")
    d = _dims(cell)
    cfg = types.SimpleNamespace(**d, num_solutions=d["num_eigenvectors"])
    rows = 2 * d["num_mics"] * d["num_srcs"] + d["num_mics"]
    plan = types.SimpleNamespace(conv_kernels=torch.zeros(2, rows, d["rir_length"]),
                                 window=torch.zeros(d["block_size"]))
    cases = chip_smoke._stream_cases(cfg, plan, lambda *shape: torch.zeros(shape))
    for name, case in cases.items():
        ops, nbytes = spec.work_counter(name).count(d, 1)
        assert (ops, nbytes) == (case["flops"], case["bytes"]), name
        ops8, nbytes8 = spec.work_counter(name).count(d, 8)
        assert (ops8, nbytes8) == (8 * ops, 8 * nbytes)


def test_kernel_names():
    assert spec.work_counter("jacobi_eigh").matches("void jacobi_pair_kernel<64, 16, false, false>(Args)")
    assert not spec.work_counter("jacobi_eigh").matches("void jacobi_pair_kernel<64, 16, true, false>(Args)")
    assert spec.work_counter("output_filter").matches("void output_filter_kernel<true>(Args)")
    assert not spec.work_counter("output_filter").matches("void output_filter_kernel<false>(Args)")
    assert spec.work_counter("streaming_conv").matches("streaming_conv_kernel(Args)")


# ---- runs on the CPU at a tiny scene -------------------------------------

def _tiny(streams: int):
    b = _bench()
    b["configs"].append(dict(name="tiny", file="benchmark/tests/data/tiny.json"))
    b["workloads"].append(dict(name=f"tiny-x{streams}", config="tiny",
                               traffic=f"../tests/data/tiny-x{streams}", chips=1))
    # The tiny cells report every metric but the live stream's split ones.
    for group in ("end_to_end", "per_layer"):
        b[group] = [m for m in b[group] if not m["name"].endswith(".live")]
        for m in b[group]:
            m.pop("workloads", None)
    return spec.load_cell(f"tiny-x{streams}", b)


def _run(cell, control=None, trace=False):
    torch.set_num_threads(1)
    return run.run_cell(cell, SEED, 1.5, trace, torch.device("cpu"), control, t_process=0.0)


@pytest.mark.parametrize("streams", [1, 2])
def test_last_line_keys(streams):
    out = _run(_tiny(streams))
    line = run.result_line(out)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"realtime_x", "hop_ms_p99", "setup_s"}
    assert set(line["compared"]) == {"stat_gap", "feed1_gap", "feed_gap", "step_deficit"}
    json.dumps(line)


def test_last_line_keys_traced():
    line = run.result_line(_run(_tiny(1), trace=True))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "compared"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in line["device"] and "window_s" in line["device"]


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("fault", sorted(faults.PLANT))
def test_faults_fail_the_comparison(fault, streams):
    """The harness driven on the CPU with the timed path broken underneath
    (``harness/faults.py``): ``correct`` comes out false."""
    out = _run(_tiny(streams), control=fault)
    assert out["verdict"]["judged"], "no hop was judged"
    assert out["verdict"]["correct"] is False, out["verdict"]["compared"]


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest -m cuda benchmark/tests)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("control", [None, "tf32", "k4_no_sweeps", "tracker_stalled"])
def test_control_fails_on_the_card(card, control):
    """s32-prod-x1 for a short window: the program is correct, and neither
    its TF32 control (the precision below float32) nor the graphed hop with
    K4 unrotated or the tracker stalled is."""
    out = run.run_cell(spec.load_cell("s32-prod-x1"), SEED, 5.0, False, card, control,
                       t_process=0.0)
    assert out["verdict"]["judged"]
    assert out["verdict"]["correct"] is (control is None), out["verdict"]["compared"]
