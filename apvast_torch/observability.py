"""Observability: per-hop quality metrics, timing, tracing and NaN guards
(port of ``apvast_tpu/observability.py``).

* :func:`hop_metrics`: structured per-hop quality metrics computed on the
  outputs' device (contrast, NMSE against the target, output RMS).
* :class:`HopTimer`: wall-clock timing that waits for the device.
* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace.
* :func:`checked_hop`: a debug hop that reports the first op to make a NaN,
  the counterpart of ``checkify`` with float and index checks.
* :func:`meter`: the process-wide :class:`HopMeter`, always on: each hop's
  host spans and rebuild cause in a ring, the tracking solver's rebuild
  decisions by cause, timed marks captured into the hop's CUDA graphs and
  read on a sample of the replays, and the set-up spans (the plan, the
  graph captures).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode

from apvast_torch.evaluation.metrics import (
    acoustic_contrast_db,
    normalized_mse,
    predict_pressure,
)

# Ops that return memory they have not written.
_UNSET = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


@dataclasses.dataclass
class HopMetrics:
    """Per-(hop, span) quality numbers, tensors on the outputs' device."""

    contrast_a_db: torch.Tensor  # (spans,)
    contrast_b_db: torch.Tensor  # (spans,)
    nmse_a: torch.Tensor  # (spans,)
    nmse_b: torch.Tensor  # (spans,)
    output_rms: torch.Tensor  # (2, spans)
    # Non-finite solver values zeroed by the engine's guards this hop
    # (int32; 0 = healthy).
    silenced: torch.Tensor  # ()


def hop_metrics(outputs, rir_a, rir_b) -> HopMetrics:
    """Quality metrics of one hop's outputs (``HopOutputs``) from the hop's
    own samples: a cheap running indicator, not the full-signal evaluation
    (``apvast_torch.evaluation`` on stitched outputs). A disabled zone
    (``out_a`` / ``out_b`` None) gets zero feeds: NaN contrast and zero
    RMS. Nothing is read back to the host."""

    def feeds(t, other):
        if t is not None:
            return t
        spans = other.shape[0] if other is not None else 1
        return torch.zeros((spans, *outputs.out_a_t.shape), dtype=outputs.out_a_t.dtype,
                           device=outputs.out_a_t.device)

    out_a = feeds(outputs.out_a, outputs.out_b)
    out_b = feeds(outputs.out_b, outputs.out_a)
    p_aa = predict_pressure(out_a, rir_a)
    p_ab = predict_pressure(out_a, rir_b)
    p_bb = predict_pressure(out_b, rir_b)
    p_ba = predict_pressure(out_b, rir_a)
    t_a = predict_pressure(outputs.out_a_t[None], rir_a)  # (1, hop, mics)
    t_b = predict_pressure(outputs.out_b_t[None], rir_b)

    def rms(x):
        return torch.sqrt((x**2).mean((-2, -1)))

    return HopMetrics(
        contrast_a_db=acoustic_contrast_db(p_aa, p_ab),
        contrast_b_db=acoustic_contrast_db(p_bb, p_ba),
        nmse_a=normalized_mse(p_aa, t_a),
        nmse_b=normalized_mse(p_bb, t_b),
        output_rms=torch.stack([rms(out_a), rms(out_b)]),
        silenced=outputs.silenced,
    )


def _tensors(tree) -> list[torch.Tensor]:
    """Every tensor in ``tree`` (tuples, lists, dicts, dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


class HopTimer:
    """Wall-clock timing that waits until the timed result exists."""

    def __init__(self):
        self.samples: list[float] = []

    @staticmethod
    def sync(result) -> None:
        """Wait for every CUDA device that holds a tensor of ``result``
        (a tensor, or tuples, lists, dicts and dataclasses of them)."""
        for device in {t.device for t in _tensors(result) if t.is_cuda}:
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def measure(self, result_ref: list):
        """``with timer.measure(out): out.append(fn(...))``: times until the
        appended result is computed."""
        t0 = time.perf_counter()
        yield
        if result_ref:
            self.sync(result_ref[-1])
        self.samples.append(time.perf_counter() - t0)

    @property
    def median_ms(self) -> float:
        s = sorted(self.samples)
        return 1000.0 * s[len(s) // 2] if s else float("nan")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over everything inside the block (CPU, and CUDA
    where there is a card); on exit a Chrome trace (``chrome://tracing``,
    Perfetto) is written under ``log_dir`` as ``trace_<time>_<pid>.json``.
    Yields the profiler, so the caller can read ``key_averages()``. While
    it is open, each of the hop meter's spans (:class:`HopMeter`) is also
    a ``record_function`` of the same name, on the trace's timeline
    around the CUDA runtime calls it makes: ``entry`` around a model's
    hop, ``stage``, ``resid`` and ``launch`` (around ``cudaGraphLaunch``)
    inside it, ``plan`` and ``capture`` while a model is built."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, _METER.mirrored():
        yield prof
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


class CheckError:
    """The outcome of a checked hop: :meth:`get` is None or the message of
    the first check that failed, :meth:`throw` raises it."""

    def __init__(self, message: str | None = None):
        self._message = message

    def get(self) -> str | None:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise FloatingPointError(self._message)


def _floating(tree) -> list[torch.Tensor]:
    return [t for t in _tensors(tree) if t.is_floating_point() or t.is_complex()]


def _has_nan(tensors) -> bool:
    return any(bool(torch.isnan(t).any()) for t in tensors)


class _NanCheck(TorchDispatchMode):
    """Records the first op that computes a NaN: a floating output holds a
    NaN while none of its floating inputs does (checkify's ``nan_checks``
    rule). Ops without floating inputs make constants (a NaN fill), which
    checkify does not check either, and ops that return unset memory
    (:data:`_UNSET`) may hold anything; neither is checked. ``sees_kernels`` makes the kernel wrappers call their ops
    (``ops/kernels/_batch.py``), so a kernel is checked as one op."""

    sees_kernels = True

    def __init__(self):
        super().__init__()
        self.message: str | None = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.message is None and func.overloadpacket.__name__ not in _UNSET:
            inputs = _floating((args, kwargs))
            if inputs and _has_nan(_floating(out)) and not _has_nan(inputs):
                self.message = f"nan generated by op: {func}"
        return out


def checked_hop(config):
    """A checked hop transition for debug runs: returns ``hop(plan, state,
    hop_a, hop_b) -> (err, (state, outputs))``, where ``err`` is a
    :class:`CheckError` naming the first op that made a NaN from inputs
    without one (an ``inf`` input is no error; the NaN an op makes from it
    is). Out-of-range indices raise in torch itself, so the index checks
    need nothing more. The hop runs eagerly, one op at a time, with a
    device read after each: never graphed, for debugging only."""

    from apvast_torch.engine.hop import process_hop

    def hop(plan, state, hop_a, hop_b):
        mode = _NanCheck()
        with mode:
            result = process_hop(config, plan, state, hop_a, hop_b)
        return CheckError(mode.message), result

    return hop


# ---- the hop meter ---------------------------------------------------------

_clock = time.perf_counter_ns

#: A hop's host spans, one ring row each: a model's whole hop call, and in
#: it the graphed hop's input copy, residual read and graph launch.
SPANS = ("entry", "stage", "resid", "launch")
#: The causes of the tracking solver's rebuild decision
#: (``engine/hop.py::rebuild_predicate``); a row holds the index, -1 where
#: its hop took no decision.
CAUSES = ("none", "warmup", "cadence", "residual")
#: The timed marks captured into each branch graph of a graphed hop, in
#: the order a hop records them: the boundaries of
#: ``engine/hop.py::process_hop``'s numbered sections, three inside
#: section 5 (``pencils``: the loaded pencils; ``factor``: the tracking
#: solver's rebuild factorization, ``ops/jdiag.py::jdiag_topk_tracked``,
#: at ``pencils`` on a plain hop and in the other solvers; ``track``: the
#: solver's step) and, last, of the state and output copies of
#: ``engine/graph.py::hop_into`` and ``GraphedHop``.
MARKS = ("start", "conv", "weight", "stats", "pencils", "factor", "track", "solve", "out",
         "writeback")
#: Each section's start and end mark: the hop's numbered sections and the
#: copies after them, then ``pencils``, ``factor``, ``track`` and
#: ``synth`` (the variable-span filters), which divide ``solve``.
SECTIONS = {
    "conv": ("start", "conv"),
    "weight": ("conv", "weight"),
    "stats": ("weight", "stats"),
    "solve": ("stats", "solve"),
    "out": ("solve", "out"),
    "writeback": ("out", "writeback"),
    "pencils": ("stats", "pencils"),
    "factor": ("pencils", "factor"),
    "track": ("factor", "track"),
    "synth": ("track", "solve"),
}
_SECTION_MARKS = [(MARKS.index(a), MARKS.index(b)) for a, b in SECTIONS.values()]
RING_ROWS = 32768  # a 20 s window at 1,600 hops a second
#: A branch's every SAMPLE_EVERY-th replay is timed by its marks: odd, so the
#: 32-hop cadence is not oversampled, prime to a 12-hop cycle, and sparse,
#: as a read costs tens of us of host.
SAMPLE_EVERY = 61
_SPAN_INDEX = {name: i for i, name in enumerate(SPANS)}
_CAUSE_INDEX = {name: i for i, name in enumerate(CAUSES)}
_NO_DECISION = -1
_EMPTY_ROW = (0, 0, 0, 0, 0, False, _NO_DECISION, False)
_ENTRY, _STAGE, _RESID, _LAUNCH, _REPLAYS, _REBUILT, _CAUSE, _PROFILED = range(8)


class HopMeter:
    """Where the port's hops spend their time, recorded always and in the
    program itself (:func:`meter` returns the process's one meter, which
    outlives the models; :meth:`reset` clears it). Every time comes from
    one clock, ``time.perf_counter_ns``; nothing here waits for the device
    or launches work outside a hop's graph.

    **Host spans.** ``entry``: a model's whole hop call
    (``process_input_buffers``, or one hop of ``process_signals`` and
    ``process_hops_span``): input checks and conversions, the graphed hop,
    the outputs' clones, the ``silenced`` and ``rebuilds`` accounting.
    Inside it, on a graphed model: ``stage`` (``GraphedHop.stage``, the
    input copy), ``resid`` (``GraphedHop._read_resid``: the residual's
    copy, its event and the wait; 0 on a hop that does not read it) and
    ``launch`` (the graph's ``replay()`` call). Each hop writes one row of
    a ring of :data:`RING_ROWS` rows (:meth:`leave`): the four spans in
    ns, whether it replayed a graph, its branch (rebuild or plain; a
    decision the device takes, batched 'newton''s, counts as plain), the
    cause of the tracking solver's decision (an index into :data:`CAUSES`,
    -1 for none), and whether a ``torch.profiler`` was recording.

    **Device sections.** While ``GraphedHop`` captures a branch
    (:meth:`capturing`), :meth:`mark` records a timing event into the
    graph at each of :data:`MARKS`; anywhere else it does nothing (eager
    hops, the CPU, the warm pass before a capture), and under
    ``torch.func.vmap`` it records once for the batch. A branch whose
    capture carries all the marks is captured a second time without
    them, and that twin is what a hop replays, so the marks cost the
    device nothing on most hops. Every :data:`SAMPLE_EVERY`-th replay of
    each branch replays the marked graph instead and is sampled: at the
    next replay, if the sampled replay's last event has completed by then,
    its section times (:data:`SECTIONS`, each from its start mark to its
    end mark) are read (libcuda's ``cuEventElapsedTime``) and kept with
    its branch; if not, the sample is kept as missed
    (:meth:`MeterWindow.samples`). The FD engine's hop carries no section
    marks.

    **Counters.** ``causes``: every decision of ``rebuild_predicate`` by
    cause since the reset (the eager hop's, the graphed hop's and the
    scene-batched hop's; batched 'newton' decides on the device and is not
    counted); ``resid_reads``: the graphed hop's residual reads.

    **Set-up spans** (:attr:`setup`, (name, seconds, owner) in order):
    ``plan`` (a model's ``build_plan``) and ``capture`` (a graphed hop's
    warm pass and branch captures), and inside it each branch's captures,
    ``capture.rebuild`` or ``capture.hop``, whose owner is the
    ``id()`` of its ``GraphedHop``.

    Under :func:`trace` each span is also a ``record_function`` of its
    name (:meth:`mirrored`). Read a timed window of a caller's hops with
    :meth:`window`. The meter takes one hop at a time: hops driven from
    several threads at once would share the open row."""

    def __init__(self):
        self._mirror = False
        self._open: list = []
        self.reset()

    def reset(self) -> None:
        """Clear the rows, samples, counters and set-up spans."""
        n = RING_ROWS
        self.hops = 0  # rows written since the reset
        # Row: (entry, stage, resid, launch ns, replays, rebuilt, cause,
        # profiled).
        self._ring: list[tuple] = [_EMPTY_ROW] * n
        self._size = n
        # The open hop's replays and its stage, resid and launch ns.
        self._cur = [0, 0, 0, 0]
        self._hop_cause = _NO_DECISION
        self.causes = dict.fromkeys(CAUSES, 0)
        self.resid_reads = 0
        self._branch_replays = [0, 0]  # replays of the plain and the rebuild branch
        self._pending = None
        # (row, branch, the section ms in SECTIONS' order, or None where missed)
        self._samples = collections.deque(maxlen=n // SAMPLE_EVERY + 4)
        self._capturing = None
        self.setup: list[tuple[str, float, int | None]] = []

    # -- recording, on the hop's path --------------------------------------

    def enter(self) -> int:
        """Open a hop's ``entry`` span; returns its start, for :meth:`leave`."""
        cur = self._cur
        cur[0] = cur[1] = cur[2] = cur[3] = 0
        self._hop_cause = _NO_DECISION
        if self._mirror:
            self._push("entry")
        return _clock()

    def leave(self, t0: int, rebuilt) -> None:
        """Close the ``entry`` span opened at ``t0`` and write the hop's
        row; ``rebuilt`` is the hop outputs' ``rebuilt``."""
        entry = _clock() - t0
        if self._mirror:
            self._pop()
        cur = self._cur
        self._ring[self.hops % self._size] = (
            entry, cur[1], cur[2], cur[3], cur[0], rebuilt is True, self._hop_cause,
            _autograd_profiler._is_profiler_enabled)
        self.hops += 1

    def begin(self, span: str) -> int:
        """Open the host span ``span`` ("stage" or "resid"); returns its
        start, for :meth:`end`."""
        if self._mirror:
            self._push(span)
        return _clock()

    def end(self, span: str, t0: int) -> None:
        """Close the host span ``span`` opened at ``t0``."""
        self._cur[_SPAN_INDEX[span]] += _clock() - t0
        if self._mirror:
            self._pop()

    def launch(self, graph, branch: bool, marked=None) -> None:
        """Replay ``graph``, the branch ``branch`` of a graphed hop, inside
        the ``launch`` span. ``marked``: the branch's twin that carries the
        timed marks, (graph, the events of :data:`MARKS`), or None. Reads
        the last sampled replay's sections first if they have completed; every
        :data:`SAMPLE_EVERY`-th replay of the branch replays the twin and
        is sampled."""
        if self._pending is not None:
            self._collect()
        replays = self._branch_replays
        replays[branch] += 1
        if marked is not None and replays[branch] % SAMPLE_EVERY == 0:
            graph, events = marked
            self._pending = (events, branch, self.hops)
        if self._mirror:
            self._push("launch")
        t0 = _clock()
        graph.replay()
        t1 = _clock()
        if self._mirror:
            self._pop()
        cur = self._cur
        cur[0] += 1
        cur[3] += t1 - t0

    def _collect(self) -> None:
        """Read the sampled replay's sections: the last pair of marks first,
        whose ``CUDA_ERROR_NOT_READY`` (any error) keeps the sample as
        missed. Through libcuda a read costs under half of what
        ``Event.elapsed_time`` costs, which queries both events first."""
        marks, branch, row = self._pending
        self._pending = None
        elapsed, ms = _libcuda_elapsed(), ctypes.c_float()
        out = ctypes.byref(ms)
        h = [event.cuda_event for event in marks]
        if elapsed(out, h[-2], h[-1]) != 0:
            self._samples.append((row, branch, None))
            return
        times = []
        for a, b in _SECTION_MARKS:
            elapsed(out, h[a], h[b])
            times.append(ms.value)
        self._samples.append((row, branch, times))

    def decided(self, cause: str) -> bool:
        """Count a rebuild decision of ``cause`` (:data:`CAUSES`) for the
        open hop; returns whether it rebuilds."""
        self.causes[cause] += 1
        self._hop_cause = _CAUSE_INDEX[cause]
        return cause != "none"

    def mark(self, name: str) -> None:
        """A timed mark ``name`` (:data:`MARKS`) in the graph being
        captured under :meth:`capturing`; nothing otherwise."""
        if self._capturing is None:
            return
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self._capturing.append((name, event))

    @contextlib.contextmanager
    def capturing(self):
        """Keep :meth:`mark`'s events while the block captures a graph.
        Yields the list that receives them, (name, event) each."""
        self._capturing = marks = []
        try:
            yield marks
        finally:
            self._capturing = None

    @contextlib.contextmanager
    def setup_span(self, name: str, owner: int | None = None):
        """Time the block as the set-up span ``name``."""
        if self._mirror:
            self._push(name)
        t0 = _clock()
        try:
            yield
        finally:
            self.setup.append((name, (_clock() - t0) * 1e-9, owner))
            if self._mirror:
                self._pop()

    @contextlib.contextmanager
    def mirrored(self):
        """Enter every span as a ``torch.profiler.record_function`` of its
        name while the block runs (:func:`trace`)."""
        before, depth = self._mirror, len(self._open)
        self._mirror = True
        try:
            yield
        finally:
            self._mirror = before
            while len(self._open) > depth:  # spans an error left open
                self._pop()

    def _push(self, name: str) -> None:
        span = torch.autograd.profiler.record_function(name)
        span.__enter__()
        self._open.append(span)

    def _pop(self) -> None:
        self._open.pop().__exit__(None, None, None)

    # -- reading -------------------------------------------------------------

    def setup_s(self, name: str) -> float | None:
        """Seconds of every set-up span ``name`` since the reset, or None
        if none ran."""
        times = [s for n, s, _ in self.setup if n == name]
        return sum(times) if times else None

    def window(self, hops: int) -> MeterWindow | None:
        """The last ``hops`` rows: a caller's timed window of that many
        hops through the models' entry points. None when the ring does not
        hold them all."""
        if hops <= 0 or hops > min(self.hops, len(self._ring)):
            return None
        if self._pending is not None:
            self._collect()
        return MeterWindow(self, self.hops - hops, hops)


_ELAPSED = None


def _libcuda_elapsed():
    """libcuda's ``cuEventElapsedTime_v2`` (``cuEventElapsedTime``
    before CUDA 12.8): ms between two recorded events, 0 when both have
    completed, ``CUDA_ERROR_NOT_READY`` (600) while either is pending."""
    global _ELAPSED
    if _ELAPSED is None:
        lib = ctypes.CDLL("libcuda.so.1")
        fn = getattr(lib, "cuEventElapsedTime_v2", None) or lib.cuEventElapsedTime
        fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ELAPSED = fn
    return _ELAPSED


class MeterWindow:
    """The rows of a window of hops (:meth:`HopMeter.window`). Host and
    device times are means over its hops that no ``torch.profiler``
    recorded (the profiler slows the host's graph launches)."""

    def __init__(self, meter: HopMeter, first: int, hops: int):
        self._m, self._first, self._last = meter, first, first + hops
        ring = meter._ring
        self._rows = [ring[(first + k) % len(ring)] for k in range(hops)]
        self.profiled = [row[_PROFILED] for row in self._rows]
        self._quiet = [row for row in self._rows if not row[_PROFILED]]

    def host_ms(self, span: str) -> float | None:
        """Mean ms of the host span ``span`` (:data:`SPANS`) a hop; for
        ``entry`` its self time (``entry`` minus the other three). None
        where no hop of the window ran it (the graph's spans on an eager
        model)."""
        rows = self._quiet
        if not rows or (span != "entry" and not any(row[_REPLAYS] for row in rows)):
            return None
        if span == "entry":
            total = sum(r[_ENTRY] - r[_STAGE] - r[_RESID] - r[_LAUNCH] for r in rows)
        else:
            k = _SPAN_INDEX[span]
            total = sum(row[k] for row in rows)
        return total * 1e-6 / len(rows)

    @property
    def causes(self) -> list[str | None]:
        """Each hop's rebuild decision cause (:data:`CAUSES`), None where it
        took none."""
        return [None if row[_CAUSE] == _NO_DECISION else CAUSES[row[_CAUSE]]
                for row in self._rows]

    def cause_share(self, cause: str) -> float | None:
        """The share of the window's hops whose rebuild decision had cause
        ``cause``; None if no hop took a decision."""
        causes = [row[_CAUSE] for row in self._rows]
        if all(c == _NO_DECISION for c in causes):
            return None
        return causes.count(_CAUSE_INDEX[cause]) / len(causes)

    def _sampled(self) -> dict[bool, list]:
        """Each branch's samples among the window's unprofiled hops: the
        section ms in :data:`SECTIONS`' order each, or None where missed."""
        by_branch: dict[bool, list] = {}
        for hop, branch, times in self._m._samples:
            if self._first <= hop < self._last and not self.profiled[hop - self._first]:
                by_branch.setdefault(branch, []).append(times)
        return by_branch

    def samples(self) -> dict[bool, tuple[int, int]]:
        """Each sampled branch's samples in the window (rebuild True, plain
        False): (read, missed). A sample is missed when its replay had not
        completed by the branch's next hop, which only a caller that does
        not wait for a hop's outputs lets happen."""
        return {branch: (sum(t is not None for t in times), sum(t is None for t in times))
                for branch, times in self._sampled().items()}

    def section_ms(self, section: str) -> float | None:
        """Mean device ms of the section ``section`` (:data:`SECTIONS`) a
        hop: each branch's mean over the window's sampled replays, weighted
        by the branch's share of the window's hops. None unless every
        branch that the window's hops took has a sample read and none
        missed: a mean without a branch, or without the replays slow enough
        to miss, would read low."""
        hops = collections.Counter(row[_REBUILT] for row in self._rows)
        total = 0.0
        for branch, n in hops.items():
            mean = self.branch_ms(section, branch)
            if mean is None:
                return None
            total += n / len(self._rows) * mean
        return total

    def branch_ms(self, section: str, branch: bool) -> float | None:
        """Mean device ms of the section ``section`` (:data:`SECTIONS`) over
        the window's sampled replays of one branch (rebuild True, plain
        False). None unless the branch has a sample read in the window and
        none missed."""
        k = list(SECTIONS).index(section)
        times = self._sampled().get(branch)
        if not times or any(t is None for t in times):
            return None
        return sum(t[k] for t in times) / len(times)


_METER = HopMeter()


def meter() -> HopMeter:
    """The process's hop meter (:class:`HopMeter`)."""
    return _METER
