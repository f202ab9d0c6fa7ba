"""Real-time stream host: sound-card callbacks <-> the AP-VAST engine (port
of ``apvast_tpu/runtime/stream_host.py``).

Topology (every boundary a native lock-free ring, no lock or allocation
on the audio thread):

    audio in A --> HopFramer A \\
    audio in B --> HopFramer B --> engine thread (the graphed hop)
                                    --> per-loudspeaker output rings
                                          --> audio out callbacks

The engine thread pops matched hop pairs, runs the hop on the card and
pushes the selected span's loudspeaker feeds; the audio side only ever
touches the native rings.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from apvast_torch.runtime.native import HopFramer, RingBuffer


class StreamHost:
    """Drive a stateful engine (:class:`apvast_torch.ApVast` or
    :class:`apvast_torch.ApVastFD`) from streaming input.

    Args:
        model: the engine; ``process_input_buffers(hop_a, hop_b)`` returns
            (out_a, out_b, ...) shaped (spans, hop, srcs).
        span_index: which span solution feeds the outputs.
        backlog_hops: input buffering before chunk pairs are dropped.
        batch_hops: above 1, when at least that many hop pairs are queued
            they are drained through the model's ``process_hops_span``: one
            upload, the hops replayed back to back, one fetch (bit for bit
            the per-hop loop), for up to ``batch_hops`` hops of added
            output latency.
        pcm_feeds: fetch the batched drain's feeds as block-scaled int16
            (half the bytes, ~90 dB below the batch peak).
    """

    def __init__(self, model, span_index: int = -1, backlog_hops: int = 8,
                 batch_hops: int = 1, pcm_feeds: bool = False):
        self.model = model
        self.span_index = span_index
        self.batch_hops = int(batch_hops)
        self.pcm_feeds = bool(pcm_feeds)
        if self.batch_hops > 1 and not hasattr(model, "process_hops_span"):
            raise ValueError("batch_hops > 1 requires a model with process_hops_span")
        cfg = model.config
        self.hop = cfg.hop
        self.num_srcs = cfg.num_srcs
        self.input_a = HopFramer(self.hop, backlog_hops)
        self.input_b = HopFramer(self.hop, backlog_hops)
        # One output ring per (zone, loudspeaker).
        self.outputs_a = [RingBuffer(self.hop * (backlog_hops + 1)) for _ in range(self.num_srcs)]
        self.outputs_b = [RingBuffer(self.hop * (backlog_hops + 1)) for _ in range(self.num_srcs)]
        self.hops_processed = 0
        self.dropped_input_chunks = 0
        self.run_a = getattr(cfg, "run_a", True)
        self.run_b = getattr(cfg, "run_b", True)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- audio side (callback safe) -------------------------------------

    def push_input(self, chunk_a, chunk_b) -> bool:
        """Push one equal-length chunk pair, atomically across both zones:
        if either framer lacks space the whole pair is dropped (counted in
        ``dropped_input_chunks``), since a partial drop would skew the two
        programs against each other for good. Returns True if accepted."""
        n_a = np.asarray(chunk_a).size
        n_b = np.asarray(chunk_b).size
        if n_a != n_b:
            raise ValueError("zone chunks must have equal length")
        if self.input_a.writable < n_a or self.input_b.writable < n_b:
            self.dropped_input_chunks += 1
            return False
        self.input_a.push(chunk_a)
        self.input_b.push(chunk_b)
        return True

    def pull_output(self, zone: str, src: int, n: int) -> np.ndarray:
        """Up to ``n`` feed samples of loudspeaker ``src`` for zone 'a' or
        'b' (any other name raises: it must not play the other zone's
        program)."""
        if zone == "a":
            rings = self.outputs_a
        elif zone == "b":
            rings = self.outputs_b
        else:
            raise ValueError(f"zone must be 'a' or 'b', got {zone!r}")
        return rings[src].read(n)

    # -- engine side ----------------------------------------------------

    def _write(self, feeds_a, feeds_b) -> None:
        """Write (n * hop, srcs) feeds of each running zone to its rings."""
        for run, feeds, rings in ((self.run_a, feeds_a, self.outputs_a),
                                  (self.run_b, feeds_b, self.outputs_b)):
            if run and feeds is not None:
                for s in range(self.num_srcs):
                    rings[s].write(feeds[:, s])

    def _fetch(self, out_a, out_b):
        """Start copying this hop's span feeds to the host (into pinned
        memory behind the hop on the card, without waiting)."""
        parts = [x[self.span_index] for run, x in ((self.run_a, out_a), (self.run_b, out_b))
                 if run and x is not None]
        feeds = torch.cat(parts, dim=1)
        cuda = feeds.device.type == "cuda"
        host = torch.empty(feeds.shape, dtype=feeds.dtype, pin_memory=cuda)
        host.copy_(feeds, non_blocking=True)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return host, event

    def _flush(self, fetched) -> None:
        host, event = fetched
        if event is not None:
            event.synchronize()
        arr = host.numpy()
        s = self.num_srcs
        feeds_a = arr[:, :s] if self.run_a else None
        feeds_b = arr[:, s if self.run_a else 0 :][:, :s] if self.run_b else None
        self._write(feeds_a, feeds_b)
        self.hops_processed += 1

    def process_pending(self, max_hops: int | None = None) -> int:
        """Run the engine on every complete input hop pair available (at
        most ``max_hops``); returns the number of hops processed.

        One hop is kept in flight: hop k is launched before hop k-1's
        feeds go to the rings, so the ring work of hop k-1 overlaps hop
        k on the card. Every output is flushed before returning."""
        done = 0
        pending = None
        while max_hops is None or done < max_hops:
            ready = min(self.input_a.ready, self.input_b.ready)
            if ready == 0:
                break
            cap = ready if max_hops is None else min(ready, max_hops - done)
            if self.batch_hops > 1 and cap >= 2:
                n = min(cap, self.batch_hops)
                wa = np.concatenate([self.input_a.pop() for _ in range(n)])
                wb = np.concatenate([self.input_b.pop() for _ in range(n)])
                if pending is not None:
                    self._flush(pending)
                    pending = None
                fa, fb = self.model.process_hops_span(
                    wa, wb, span_index=self.span_index, pcm=self.pcm_feeds
                )
                self._write(fa, fb)
                self.hops_processed += n
                done += n
                continue
            out_a, out_b, *_ = self.model.process_input_buffers(
                self.input_a.pop(), self.input_b.pop()
            )
            fetched = self._fetch(out_a, out_b)
            if pending is not None:
                self._flush(pending)
            pending = fetched
            done += 1
        if pending is not None:
            self._flush(pending)
        return done

    def start(self, poll_seconds: float = 0.001) -> None:
        """Run the engine loop on a background thread. With
        ``batch_hops > 1`` the thread waits for a full batch (a shorter
        remainder drains at :meth:`stop`); per hop it drains at once."""

        def loop():
            while not self._stop.is_set():
                ready = min(self.input_a.ready, self.input_b.ready)
                if self.batch_hops > 1 and ready < self.batch_hops:
                    self._stop.wait(poll_seconds)
                    continue
                if self.process_pending(max_hops=max(1, self.batch_hops)) == 0:
                    self._stop.wait(poll_seconds)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the background thread and drain the remainder. If the
        thread does not exit within 5 s (a long drain in flight), the
        remainder is left to it, with a warning: draining from this thread
        too would run the model concurrently on one state."""
        self._stop.set()
        drained = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                drained = False
                warnings.warn(
                    "StreamHost.stop(): worker thread did not exit within 5 s (long batched "
                    "drain in flight); skipping the caller-side remainder drain",
                    RuntimeWarning,
                    stacklevel=2,
                )
            self._thread = None
        if drained:
            self.process_pending()

    @property
    def dropped_input_hops(self) -> int:
        """The framers' short-write drops: 0 under :meth:`push_input`,
        whose admission check drops whole pairs first (see
        ``dropped_input_chunks``); nonzero only if a caller pushes the
        framers directly."""
        return self.input_a.dropped + self.input_b.dropped
