"""The cell's specification, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics. A
cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``); a metric is read by
``benchmark/metrics/<name>.py`` and a kernel's work is counted by
``benchmark/work/<kernel>.py``. A new cell, configuration, mix, metric or
kernel is new files and entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str):
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]

    @property
    def streams(self) -> int:
        return int(self.traffic["streams"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark() -> dict:
    """The checkout's ``BENCHMARK.json``."""
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell ``name`` of ``benchmark`` (default: the root's
    ``BENCHMARK.json``) with its configuration and traffic files."""
    bench = benchmark if benchmark is not None else load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_json(os.path.join(ROOT, cfg_entry["file"])),
        traffic=_json(os.path.join(BENCH_DIR, "traffic", f"{entry['traffic']}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``benchmark/metrics/<name>.py``."""
    return _module("metrics", name).read


def work_counter(kernel: str):
    """The module ``benchmark/work/<kernel>.py``: ``NAME`` (what its device
    time is found by), ``matches(kernel_name)`` and ``count(dims, scenes)
    -> (operations, bytes)`` of one hop."""
    return _module("work", kernel)


def peaks() -> dict:
    """The card's published peaks (``benchmark/work/peaks.json``)."""
    return _json(os.path.join(BENCH_DIR, "work", "peaks.json"))
