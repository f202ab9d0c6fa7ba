"""Observability: per-hop quality metrics, timing, tracing and NaN guards
(port of ``apvast_tpu/observability.py``).

* :func:`hop_metrics`: structured per-hop quality metrics computed on the
  outputs' device (contrast, NMSE against the target, output RMS).
* :class:`HopTimer`: wall-clock timing that waits for the device.
* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace.
* :func:`checked_hop`: a debug hop that reports the first op to make a NaN,
  the counterpart of ``checkify`` with float and index checks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apvast_torch.engine.hop import process_hop
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
    Yields the profiler, so the caller can read ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
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

    def hop(plan, state, hop_a, hop_b):
        mode = _NanCheck()
        with mode:
            result = process_hop(config, plan, state, hop_a, hop_b)
        return CheckError(mode.message), result

    return hop
