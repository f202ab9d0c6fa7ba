"""The hop meter (``apvast_torch/observability.py::HopMeter``) on the CPU:
each hop's rebuild cause against the model's own rebuilds, hop for hop,
through the eager single-scene hop and the scene-batched (vmapped) hop;
the timed marks doing nothing off a capture (on the CPU and under
``torch.func.vmap``), with the hop's outputs bit for bit those of a hop
without them, and recorded once for the batch under a capture; the ring
wrapping and keeping a timed window's rows aligned with a harness-style
record of hop times and profiled flags; ``trace`` mirroring the spans
into its own profiler and no other; the sampled reading of the device
sections (with stand-ins for a graph, its events and libcuda), late,
missed while pending, weighted by branch; and each of the benchmark's readers
of the meter on a short CPU run, None where its span runs only in a
graph on the card; the sections inside ``solve`` summing to it, the
hop's six sections reading between the marks they read before, and the
per-branch reader. The card's side (marks in both branch graphs, the
sections against the replay, no added sync, ``launch`` around
``cudaGraphLaunch``) is in ``tests/test_torch_cuda.py``."""

import importlib.util
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from apvast_torch import ApVast, ApVastConfig, MultiSceneApVast, process_hop, production_overrides
from apvast_torch.engine.graph import clone_state
from apvast_torch.observability import (
    CAUSES, MARKS, RING_ROWS, SAMPLE_EVERY, SECTIONS, meter, trace,
)
from apvast_torch.utils.rir import synthetic_rirs
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
HOP = 64
STEP_AT = 20  # a +20 dB level step here fires the residual trigger
HOPS = 40  # past the 32-hop cadence

NEW_METRICS = {
    # name: whether a CPU run (eager hops) gives it a value
    "entry_host_ms": True, "stage_host_ms": False, "resid_wait_ms": False,
    "launch_host_ms": False, "writeback_dev_ms": False, "conv_dev_ms": False,
    "weight_dev_ms": False, "stats_dev_ms": False, "solve_dev_ms": False,
    "out_dev_ms": False, "resid_rebuild_share": True, "resid_rebuild_share.live": True,
    "capture_s": False, "plan_s": True, "factor_dev_ms": False, "track_dev_ms": False,
}


def _pairs(n):
    return [(synthetic_rirs(120, 4, 3, seed=2 * i + 1), synthetic_rirs(120, 4, 3, seed=2 * i + 2))
            for i in range(n)]


def _config():
    return ApVastConfig.for_rirs(
        *_pairs(1)[0], block_size=128, filter_length=16, modeling_delay=5,
        reference_index_a=1, reference_index_b=2, num_eigenvectors=6, mu=1.0,
        statistics_buffer_length=160, sampling_rate=8000, perceptual=True,
        **production_overrides())


def _single():
    ra, rb = _pairs(1)[0]
    return ApVast(128, ra, rb, 16, 5, 1, 2, 6, 1.0, 160, sampling_rate=8000, perceptual=True,
                  device="cpu", generator=torch.Generator().manual_seed(0),
                  **production_overrides())


def _batched(n=2):
    return MultiSceneApVast(_config(), _pairs(n), device="cpu")


def _signal(rng, h, shape=(HOP,)):
    return (0.1 if h < STEP_AT else 1.0) * rng.standard_normal(shape)


@pytest.fixture
def fresh_meter():
    meter().reset()
    yield meter()
    meter().reset()


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_rebuild_causes_match_rebuilds_hop_for_hop(fresh_meter, batched):
    """Each hop's cause in the ring against the model's own rebuild that
    hop: the six warmup hops, the cadence at hop 32, and a residual
    trigger after the level step; the counters sum to the rebuilds."""
    model = _batched() if batched else _single()
    rng = np.random.default_rng(3)
    rebuilt = []
    for h in range(HOPS):
        before = model.rebuilds
        if batched:
            model.process_input_buffers(_signal(rng, h, (2, HOP)), _signal(rng, h, (2, HOP)))
        else:
            model.process_input_buffers(_signal(rng, h), _signal(rng, h))
        rebuilt.append(model.rebuilds != before)
    causes = fresh_meter.window(HOPS).causes
    assert [c != "none" for c in causes] == rebuilt
    assert causes[:6] == ["warmup"] * 6 and causes[32] == "cadence"
    assert "residual" in causes[STEP_AT:32]
    assert "residual" not in causes[6:STEP_AT]
    counts = fresh_meter.causes
    assert sum(counts.values()) == HOPS
    assert counts["warmup"] + counts["cadence"] + counts["residual"] == model.rebuilds
    assert counts["residual"] == causes.count("residual")
    assert fresh_meter.window(HOPS).cause_share("residual") == causes.count("residual") / HOPS


class _NoEvent:
    def __init__(self, *args, **kwargs):
        raise AssertionError("a timed event was made outside a capture")


class _FakeEvent:
    """Stands in for a CUDA timing event on the CPU: counts its records."""

    def __init__(self, *args, **kwargs):
        self.records = 0

    def record(self, *args):
        self.records += 1


def _hop_twice(batched, rng):
    """One hop from the same state with the meter's marks, then with
    ``mark`` replaced by nothing: (outputs with, outputs without)."""
    model = _batched() if batched else _single()
    for h in range(8):
        shape = (2, HOP) if batched else (HOP,)
        model.process_input_buffers(_signal(rng, h, shape), _signal(rng, h, shape))
    a, b = (torch.as_tensor(_signal(rng, 0, (2, HOP) if batched else (HOP,))) for _ in range(2))
    saved = clone_state(model.state)
    if batched:
        step = lambda: model._hop(model.plan, clone_state(saved), a, b)  # noqa: E731
    else:
        step = lambda: process_hop(model.config, model.plan, clone_state(saved), a, b)  # noqa: E731
    return step


@pytest.mark.parametrize("batched", [False, True], ids=["cpu", "vmap"])
def test_marks_do_nothing_off_a_capture(fresh_meter, monkeypatch, batched):
    """Off a capture ``mark`` makes no event (any would raise here), on
    the CPU and under vmap, and the hop's state and outputs are bit for
    bit those of the hop with ``mark`` taken out."""
    step = _hop_twice(batched, np.random.default_rng(5))
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "Event", _NoEvent)
        new_with, out_with = step()
    with monkeypatch.context() as mp:
        mp.setattr(type(fresh_meter), "mark", lambda self, name: None)
        new_without, out_without = step()
    for got, want in ((new_with, new_without), (out_with, out_without)):
        for name in vars(want):
            x, y = getattr(got, name), getattr(want, name)
            if isinstance(y, torch.Tensor):
                assert torch.equal(x, y), name
            else:
                assert x == y, name


def test_marks_record_once_for_the_batch_under_a_capture(fresh_meter, monkeypatch):
    """Under :meth:`HopMeter.capturing` the vmapped hop of two scenes
    records each of ``process_hop``'s marks once, in order (the graph's
    own ``writeback`` mark comes after the copies ``GraphedHop`` adds)."""
    step = _hop_twice(True, np.random.default_rng(6))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    with fresh_meter.capturing() as marks:
        step()
    assert [name for name, _ in marks] == list(MARKS[:-1])
    assert all(event.records == 1 for _, event in marks)
    assert fresh_meter._capturing is None
    fresh_meter.mark("out")  # off the capture again: nothing


def _harness_run(model, warm, window, profiled_from=None, profiled_hops=0, seed=7):
    """Hops as the benchmark's closed loop drives them: ``warm`` hops,
    then a window of ``window`` timed hops whose ``profiled_hops`` from
    ``profiled_from`` run under a ``torch.profiler``. Returns the
    record's ``hop_s``, ``rebuilt`` and ``profiled`` lists."""
    rng = np.random.default_rng(seed)
    for h in range(warm):
        model.process_input_buffers(rng.standard_normal(HOP), rng.standard_normal(HOP))
    rec = dict(hop_s=[], rebuilt=[], profiled=[])
    prof = None
    for k in range(window):
        if k == profiled_from:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
            prof.start()
        in_prof = prof is not None and profiled_from <= k < profiled_from + profiled_hops
        before = model.rebuilds
        t0 = time.perf_counter()
        model.process_input_buffers(rng.standard_normal(HOP), rng.standard_normal(HOP))
        rec["hop_s"].append(time.perf_counter() - t0)
        rec["rebuilt"].append(model.rebuilds != before)
        rec["profiled"].append(in_prof)
        if prof is not None and k == profiled_from + profiled_hops - 1:
            prof.stop()
            prof = None
    return rec


def _bench_module(name):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"meter_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ring_wraps_and_keeps_the_window_aligned(fresh_meter, monkeypatch):
    """A 16-row ring over 8 warm and 30 window hops: it wraps, the last
    12 rows carry the record's profiled flags and rebuilds hop for hop,
    host means leave the profiled hops out, and a window longer than the
    ring, or a record whose flags do not match, reads as None."""
    import apvast_torch.observability as obs

    monkeypatch.setattr(obs, "RING_ROWS", 16)
    fresh_meter.reset()
    model = _single()
    rec = _harness_run(model, 8, 30, profiled_from=22, profiled_hops=4)
    assert fresh_meter.hops == 38 and len(fresh_meter._ring) == 16
    tail = {k: v[-12:] for k, v in rec.items()}
    w = fresh_meter.window(12)
    assert w.profiled == tail["profiled"] and sum(tail["profiled"]) == 4
    assert [c != "none" for c in w.causes] == tail["rebuilt"]
    assert w.causes[32 - 26] == "cadence"  # hop 32 of the run, 26 hops before the tail
    quiet = [row for row, p in zip(w._rows, w.profiled) if not p]
    want = sum(r[0] - r[1] - r[2] - r[3] for r in quiet) * 1e-6 / len(quiet)
    assert w.host_ms("entry") == pytest.approx(want, rel=1e-12) and want > 0
    assert fresh_meter.window(17) is None and fresh_meter.window(0) is None
    helper = _bench_module("entry_host_ms").__dict__["host_ms"]
    assert helper(tail, "entry") == pytest.approx(want, rel=1e-12)
    shifted = dict(tail, profiled=[False] + tail["profiled"][:-1])
    assert helper(shifted, "entry") is None
    assert helper(dict(rec), "entry") is None  # 30 hops: the ring holds 16


@pytest.fixture(scope="module")
def cpu_run():
    """A short harness-style CPU run for the readers: 8 warm hops and a
    40-hop window (the cadence at hop 32), four of them profiled."""
    meter().reset()
    model = _single()
    rec = _harness_run(model, 8, 40, profiled_from=10, profiled_hops=4)
    del model
    yield rec
    meter().reset()


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_benchmark_reader_of_the_meter(cpu_run, name):
    """Each new reader on the CPU run's record: a value where an eager hop
    runs its span (the entry, the rebuild causes, the plan), None where
    only a graph on the card does (stage, residual read, launch, the
    device sections, the capture)."""
    value = _bench_module(name).read(cpu_run)
    if not NEW_METRICS[name]:
        assert value is None
        return
    assert isinstance(value, float) and np.isfinite(value)
    if name.startswith("resid_rebuild_share"):
        w = meter().window(len(cpu_run["hop_s"]))
        assert value == w.causes.count("residual") / len(cpu_run["hop_s"])
    else:
        assert value > 0


def test_trace_mirrors_the_spans_into_its_own_profiler_only(fresh_meter, tmp_path):
    """Under ``trace`` each hop's ``entry`` and the model's ``plan`` are
    ``record_function`` spans in the written Chrome trace; a profiler that
    ``trace`` did not open sees none of them."""
    with trace(str(tmp_path)):
        model = _single()
        for _ in range(2):
            model.process_input_buffers(np.zeros(HOP), np.zeros(HOP))
    assert fresh_meter._mirror is False and not fresh_meter._open
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("entry") == 2 and names.count("plan") == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.process_input_buffers(np.zeros(HOP), np.zeros(HOP))
    assert "entry" not in {e.name for e in prof.events()}
    assert fresh_meter.window(1).profiled == [True]


def test_sampling_constants():
    """One odd sampling period, so that the 32-hop cadence's rebuild hops
    are sampled at their share, prime to a 12-hop cycle (a syllable-rate
    level envelope); the ring holds a 20 s window at four times the
    fastest cell's hop rate; ten marks, ten sections, each between two
    marks in the order a hop records them."""
    assert SAMPLE_EVERY % 2 == 1 and np.gcd(SAMPLE_EVERY, 32) == 1
    assert np.gcd(SAMPLE_EVERY, 12) == 1
    assert RING_ROWS >= 32768
    assert len(MARKS) == 10 and len(SECTIONS) == 10
    assert all(MARKS.index(a) < MARKS.index(b) for a, b in SECTIONS.values())
    assert CAUSES == ("none", "warmup", "cadence", "residual")


def test_marks_in_the_order_a_hop_records_them():
    """The three marks inside section 5 lie between ``stats`` and
    ``solve``, in the solver's order: the loaded pencils, the rebuild
    factorization, the tracker's step."""
    assert MARKS == ("start", "conv", "weight", "stats", "pencils", "factor", "track", "solve",
                     "out", "writeback")
    assert list(SECTIONS)[:6] == ["conv", "weight", "stats", "solve", "out", "writeback"]
    assert [SECTIONS[k] for k in ("pencils", "factor", "track", "synth")] == [
        ("stats", "pencils"), ("pencils", "factor"), ("factor", "track"), ("track", "solve")]


# Stand-ins for a graph, its timed events and libcuda's elapsed time. Each
# branch's mark timestamps: the plain branch's sections between
# consecutive marks take 1, 2, ..., 9 ms; the rebuild branch's 2 ms each.
STAMPS = {False: (0, 1, 3, 6, 10, 15, 21, 28, 36, 45), True: tuple(range(0, 20, 2))}
# The six sections as the meter read them with seven marks: from each of
# these marks to the next.
SEVEN_MARKS = ("start", "conv", "weight", "stats", "solve", "out", "writeback")


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Event:
    def __init__(self, handle):
        self.cuda_event = handle


def _sampled_run(meter_, monkeypatch, missed_plain=True):
    """4 SAMPLE_EVERY + 11 hops through ``launch`` with a rebuild on every
    fourth hop, each branch's marks stamped by :data:`STAMPS`; with
    ``missed_plain`` the first plain sample is read before it completes.
    Returns (rebuilt_at, sampled hops, replays of each branch, graphs,
    twins)."""
    import apvast_torch.observability as obs

    ready = [True]

    def elapsed(out, a, b):
        if not ready[0]:
            return 600  # CUDA_ERROR_NOT_READY
        out._obj.value = float(b - a)
        return 0

    monkeypatch.setattr(obs, "_libcuda_elapsed", lambda: elapsed)
    marks = {b: [_Event(t) for t in STAMPS[b]] for b in (False, True)}
    graphs = {b: _Graph() for b in (False, True)}
    twins = {b: _Graph() for b in (False, True)}
    n = 4 * SAMPLE_EVERY + 11
    rebuilt_at = [h % 4 == 1 for h in range(n)]
    sampled, seen = [], {False: 0, True: 0}
    for h, rebuilt in enumerate(rebuilt_at):
        seen[rebuilt] += 1
        if seen[rebuilt] % SAMPLE_EVERY == 0:
            sampled.append(h)
    first_plain = next(h for h in sampled if not rebuilt_at[h])
    for h, rebuilt in enumerate(rebuilt_at):
        ready[0] = not missed_plain or h != first_plain + 1
        t0 = meter_.enter()
        meter_.decided("residual" if rebuilt else "none")
        meter_.launch(graphs[rebuilt], rebuilt, (twins[rebuilt], marks[rebuilt]))
        meter_.leave(t0, rebuilt)
    return rebuilt_at, sampled, seen, graphs, twins


def _stamped(branch, section):
    a, b = SECTIONS[section]
    return STAMPS[branch][MARKS.index(b)] - STAMPS[branch][MARKS.index(a)]


def test_sampled_sections_are_read_late_and_weighted_by_branch(fresh_meter, monkeypatch):
    """The device sections' sampling with stand-ins for the graphs, their
    timed events and libcuda's elapsed time: every SAMPLE_EVERY-th replay
    of each branch replays the branch's marked twin and is read at the
    next launch, a replay not yet complete there is kept as missed, and
    each branch's mean is weighted by the branch's share of the window's
    hops. A window with a missed sample, or with hops of a branch that has
    no sample in it, reads as None."""
    rebuilt_at, sampled, seen, graphs, twins = _sampled_run(fresh_meter, monkeypatch)
    n = len(rebuilt_at)
    first_plain = next(h for h in sampled if not rebuilt_at[h])
    reb = next(h for h in sampled if rebuilt_at[h])
    assert first_plain < reb < max(sampled)  # plain, ..., rebuild, plain
    assert [row for row, _, _ in fresh_meter._samples] == sampled
    assert [b for _, b, _ in fresh_meter._samples] == [rebuilt_at[h] for h in sampled]
    for b in (False, True):
        want = sum(rebuilt_at[h] == b for h in sampled)
        assert twins[b].replays == want and graphs[b].replays == seen[b] - want
    w = fresh_meter.window(n)
    plain_samples = sum(not rebuilt_at[h] for h in sampled)
    assert w.samples() == {False: (plain_samples - 1, 1), True: (1, 0)}
    assert w.section_ms("conv") is None  # a missed sample
    assert w.host_ms("launch") >= 0 and w.host_ms("stage") == 0
    # Past the missed sample: both branches read, weighted by their hops.
    hops = n - first_plain - 1
    share = sum(rebuilt_at[-hops:]) / hops
    w = fresh_meter.window(hops)
    assert w.samples() == {False: (plain_samples - 1, 0), True: (1, 0)}
    for section in SECTIONS:
        want = (1 - share) * _stamped(False, section) + share * _stamped(True, section)
        assert w.section_ms(section) == pytest.approx(want)
    # Past the rebuild sample, rebuild hops with no sample: None, not the
    # plain branch's mean.
    w = fresh_meter.window(n - reb - 1)
    assert w.samples() == {False: (1, 0)} and any(rebuilt_at[reb + 1:])
    assert w.section_ms("solve") is None


def test_solve_is_the_sum_of_its_four_parts(fresh_meter, monkeypatch):
    """On the stand-ins' rows, ``pencils`` + ``factor`` + ``track`` +
    ``synth`` equal ``solve``: in each branch and weighted by branch."""
    _sampled_run(fresh_meter, monkeypatch, missed_plain=False)
    w = fresh_meter.window(fresh_meter.hops)
    parts = ("pencils", "factor", "track", "synth")
    for read in (w.section_ms, lambda s: w.branch_ms(s, False), lambda s: w.branch_ms(s, True)):
        assert read("solve") > 0
        assert sum(read(p) for p in parts) == pytest.approx(read("solve"), rel=1e-12)


@pytest.mark.parametrize("section", SEVEN_MARKS[1:])
def test_hop_sections_read_what_they_read_with_seven_marks(fresh_meter, monkeypatch, section):
    """Each of the hop's six sections runs between the marks it ran
    between before the marks inside ``solve`` came, and reads, on the
    stand-ins' rows, the time between those two marks."""
    k = SEVEN_MARKS.index(section)
    assert SECTIONS[section] == (SEVEN_MARKS[k - 1], SEVEN_MARKS[k])
    rebuilt_at, *_ = _sampled_run(fresh_meter, monkeypatch, missed_plain=False)
    w = fresh_meter.window(len(rebuilt_at))
    share = sum(rebuilt_at) / len(rebuilt_at)
    start, end = (MARKS.index(m) for m in SEVEN_MARKS[k - 1:k + 1])
    before = {b: STAMPS[b][end] - STAMPS[b][start] for b in (False, True)}
    assert w.section_ms(section) == pytest.approx((1 - share) * before[False] + share * before[True])


def test_branch_reader_none_rules(fresh_meter, monkeypatch):
    """``branch_ms``: one branch's mean over its read samples in the
    window; None for a branch with a missed sample in the window, and for
    a branch with no sample there, whatever the other branch holds. The
    benchmark's ``factor_dev_ms`` reads the rebuild branch's ``factor``
    section alone and ``track_dev_ms`` the weighted ``track`` section."""
    rebuilt_at, sampled, *_ = _sampled_run(fresh_meter, monkeypatch)
    n = len(rebuilt_at)
    first_plain = next(h for h in sampled if not rebuilt_at[h])
    reb = next(h for h in sampled if rebuilt_at[h])
    w = fresh_meter.window(n)
    assert w.branch_ms("factor", False) is None  # the missed plain sample
    assert w.branch_ms("factor", True) == _stamped(True, "factor")
    w = fresh_meter.window(n - first_plain - 1)
    assert w.branch_ms("factor", False) == _stamped(False, "factor")
    assert w.branch_ms("track", False) == _stamped(False, "track")
    w = fresh_meter.window(n - reb - 1)  # no rebuild sample
    assert w.branch_ms("factor", True) is None
    assert w.branch_ms("factor", False) == _stamped(False, "factor")
    # The benchmark's readers on a record of the window past the missed
    # sample.
    hops = n - first_plain - 1
    record = dict(hop_s=[1e-3] * hops, rebuilt=rebuilt_at[-hops:], profiled=[False] * hops)
    assert _bench_module("factor_dev_ms").read(record) == _stamped(True, "factor")
    share = sum(rebuilt_at[-hops:]) / hops
    want = (1 - share) * _stamped(False, "track") + share * _stamped(True, "track")
    assert _bench_module("track_dev_ms").read(record) == pytest.approx(want)
    record = dict(hop_s=[1e-3] * n, rebuilt=rebuilt_at, profiled=[False] * n)
    assert _bench_module("factor_dev_ms").read(record) == _stamped(True, "factor")
    assert _bench_module("track_dev_ms").read(record) is None  # the missed plain sample
