"""What the profiled slice of a ``--trace 1`` window shows: device time by
kernel name, the device's busy time, the device operations that took most
time, and the device's idle gaps by what the host was doing then.

A replayed CUDA graph runs no aten op on the host, so kernels are told
apart by name only (``benchmark/work/<kernel>.py`` says which names are
whose). The host's side of each hop carries the harness's own spans
(``bench.*``, :mod:`harness.drive`) beside the CUDA runtime's calls.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from torch.autograd import DeviceType

TOP = 10
SPAN_PREFIX = "bench."  # the harness's own host spans (harness.drive)


def _span(e):
    tr = e.time_range
    return float(tr.start), float(tr.end)


def read(prof) -> dict:
    """``kernels`` {name: device seconds}, ``busy_s`` (the union of device
    operations' intervals), ``device_ops`` and ``idle_gaps`` (the
    breakdown: [name, seconds], at most ``TOP`` each, longest first)."""
    dev, host = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(SPAN_PREFIX):
                continue  # a host span's shadow on the device timeline, not an operation
            dev.append((*_span(e), e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((*_span(e), e.name))
    kernels = defaultdict(float)
    for start, end, name in dev:
        kernels[name] += (end - start) * 1e-6
    if not dev:
        # No timeline: the per-kernel sums alone.
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                    and not e.key.startswith(SPAN_PREFIX)):
                kernels[e.key] += e.self_device_time_total * 1e-6
        return dict(kernels=dict(kernels), busy_s=sum(kernels.values()),
                    device_ops=_top(kernels), idle_gaps=[])
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    busy = 0.0
    gaps = defaultdict(float)
    cur_start, cur_end = dev[0][0], dev[0][1]
    for start, end, _ in dev[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            gaps[_doing(host, starts, 0.5 * (cur_end + start))] += (start - cur_end) * 1e-6
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return dict(kernels=dict(kernels), busy_s=busy * 1e-6, device_ops=_top(kernels),
                idle_gaps=_top(gaps))


def _doing(host, starts, t) -> str:
    """The innermost host event open at ``t`` (the latest started among
    the recent ones that have not ended)."""
    i = bisect.bisect_right(starts, t)
    for k in range(i - 1, max(-1, i - 400), -1):
        start, end, name = host[k]
        if end >= t:
            return name
    return "(no host event)"


def _top(totals: dict) -> list:
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:160], seconds] for name, seconds in rows]
