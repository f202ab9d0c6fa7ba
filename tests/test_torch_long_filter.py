"""The port's production hop with filters as long as the reference's
published ones (J = 100, ``Python/make_python_test.m``), held to the
benchmark's float64 reference on the CPU.

A tap-heavy small scene (4 loudspeakers, 5 microphones, J = 100, so JL =
400, against the benchmark's tiny scene's J = 16) runs through the
benchmark's own harness (``benchmark/run.py::run_cell``): ``ApVast`` for
one stream and ``MultiSceneApVast`` for two, eager, under
``production_overrides()`` with the plain versions of the kernels. The
harness's comparison (``benchmark/harness/judge.py``, against
``benchmark/reference/hop.py`` in float64) finds the program correct on
two seeds each, and fails it under every fault of
``benchmark/harness/faults.py``. The same cell on the card at JL = 3200
is ``benchmark/tests/test_bench_long_filter.py``.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import run  # noqa: E402
from harness import faults, spec  # noqa: E402

# The benchmark's tiny scene with the published filter length: the
# statistics buffer holds at least 2 J + 1 samples and fits in a block.
# With a buffer of 240 samples (block 256) the 5 microphones' statistics
# determine the JL = 400 pencils so loosely that the incoming Ritz pairs
# miss the residual trigger on every hop, which then rebuilds, and the
# tracker's own step is never judged; 512 leaves plain hops.
LONG = dict(filter_length=100, block_size=512, statistics_buffer_length=512)
SEEDS = (2**31 + 977, 3_000_000_019)


def _cell(streams: int):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(name="tiny", file="benchmark/tests/data/tiny.json"))
    b["workloads"].append(dict(name=f"tiny-x{streams}", config="tiny",
                               traffic=f"../tests/data/tiny-x{streams}", chips=1))
    for group in ("end_to_end", "per_layer"):
        b[group] = [m for m in b[group] if not m["name"].endswith(".live")]
        for m in b[group]:
            m.pop("workloads", None)
    cell = spec.load_cell(f"tiny-x{streams}", b)
    config = dict(cell.config, name="tiny-j100", scene=dict(cell.config["scene"], **LONG))
    return dataclasses.replace(cell, name=f"tiny-j100-x{streams}", config=config)


def _run(streams: int, seed: int, control=None):
    torch.set_num_threads(1)
    return run.run_cell(_cell(streams), seed, 1.5, False, torch.device("cpu"), control,
                        t_process=0.0)


def test_the_scene_is_tap_heavy():
    sc = _cell(1).config["scene"]
    assert sc["filter_length"] == 100 and sc["num_srcs"] * sc["filter_length"] == 400
    assert 2 * sc["filter_length"] + 1 <= sc["statistics_buffer_length"] <= sc["block_size"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("streams", [1, 2])
def test_long_filters_are_correct(streams, seed):
    """Correct, on a run with plain hops past the warmup: the tracker's
    own step is judged, not only the rebuild's."""
    out = _run(streams, seed)
    verdict, flags = out["verdict"], out["record"]["rebuilt_tau"]
    assert verdict["judged"], "no hop was judged"
    assert not all(flags[6:])
    assert out["record"]["failed"] == 0
    assert verdict["correct"] is True, verdict["compared"]


@pytest.mark.parametrize("fault", sorted(faults.PLANT))
def test_faults_fail_the_long_filters(fault):
    out = _run(2 if fault in faults.AFTER_BUILD else 1, SEEDS[0], control=fault)
    assert out["verdict"]["judged"], "no hop was judged"
    assert out["verdict"]["correct"] is False, out["verdict"]["compared"]
