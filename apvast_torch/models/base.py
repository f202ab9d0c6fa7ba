"""What the models share: the hop dispatched eagerly or as a replayed CUDA
graph (``engine/graph.py``; :class:`GraphDispatch`, also under
:class:`~apvast_torch.models.multi_scene.MultiSceneApVast`), and what
:class:`ApVast` and :class:`ApVastFD` share besides: the per-hop entry
point and the serving drain ``process_hops_span`` (port of
``apvast_tpu/models/apvast.py::ApVast.process_hops_span``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apvast_torch.engine.graph import GraphedHop, graph_reason
from apvast_torch.engine.hop import HopOutputs
from apvast_torch.engine.stream import stitch_outputs
from apvast_torch.observability import meter
from apvast_torch.utils.device import torch_dtype

_meter = meter()


class GraphDispatch:
    """The hop run eagerly or as a replayed CUDA graph. Subclasses set
    ``config``, ``plan`` and ``device`` and call :meth:`_init_dispatch`.

    ``graph`` (a constructor argument of every model): None captures the
    hop as a CUDA graph on the card when the configuration allows it
    (:func:`apvast_torch.engine.graph.eager_reason`) and runs it eagerly
    otherwise; False runs it eagerly; True requires the graph and raises
    ValueError, naming the reason, on a configuration that cannot be
    captured and on the CPU. ``graphed`` says which runs."""

    _fd = False
    _batched = False  # the scene-batched hop (MultiSceneApVast)
    forgetting = 0.9

    def _init_dispatch(self, graph: bool | None) -> None:
        reason = graph_reason(self.config, self.device, self._fd, self._batched,
                              getattr(self, "mesh", None))
        if graph and reason is not None:
            raise ValueError(f"graph=True: {reason}")
        self.graphed = reason is None if graph is None else bool(graph)
        self.eager_reason = reason
        self._graph: GraphedHop | None = None
        self._state = None

    @property
    def state(self):
        """The engine state. On a graphed model it is the graph's static
        state, whose tensors change in place with every hop (clone what you
        keep); assigning a state copies it in."""
        return self._state if self._graph is None else self._graph.state

    @state.setter
    def state(self, value) -> None:
        if not self.graphed:
            self._state = value
        elif self._graph is None:
            self._graph = GraphedHop(self.config, self.plan, value, self.forgetting,
                                     batched=self._batched)
        else:
            self._graph.load(value)

    @property
    def graph(self) -> GraphedHop | None:
        """The captured hop (None on an eager model)."""
        return self._graph

    def _kept(self, out: HopOutputs) -> HopOutputs:
        """``out`` with fresh feed tensors (a graph's outputs are its static
        buffers), and a fresh per-scene ``rebuilt``."""
        if self._graph is None:
            return out
        return dataclasses.replace(out, **{
            name: getattr(out, name).clone()
            for name in ("out_a", "out_b", "out_a_t", "out_b_t", "rebuilt")
            if isinstance(getattr(out, name), torch.Tensor)
        })


class HopModel(GraphDispatch):
    """One scene's hop (``ApVast``, ``ApVastFD``): subclasses implement
    :meth:`_eager_hop` and :attr:`_num_outputs` besides what
    :class:`GraphDispatch` asks."""

    def _signal(self, x) -> torch.Tensor:
        return torch.as_tensor(x).reshape(-1).to(
            device=self.device, dtype=torch_dtype(self.config)
        )

    def _check_hop(self, input_a, input_b):
        hop = self.config.hop
        if input_a.shape[0] != hop or input_b.shape[0] != hop:
            raise ValueError(f"inputs must be exactly hop={hop} samples")

    def _step(self, input_a, input_b) -> HopOutputs:
        """One hop, metered as the hop meter's ``entry``; on a graphed model
        the outputs are the graph's static buffers, which the next hop
        overwrites."""
        t0 = _meter.enter()
        out = self._advance(input_a, input_b)
        _meter.leave(t0, out.rebuilt)
        return out

    def _advance(self, input_a, input_b) -> HopOutputs:
        """:meth:`_step` without the meter's ``entry`` span."""
        if self._graph is None:
            input_a, input_b = self._signal(input_a), self._signal(input_b)
            self._check_hop(input_a, input_b)
            out = self._eager_hop(input_a, input_b)
        else:
            if not isinstance(input_a, torch.Tensor):
                input_a = np.asarray(input_a).reshape(-1)
                input_b = np.asarray(input_b).reshape(-1)
            self._check_hop(input_a.reshape(-1), input_b.reshape(-1))
            self._graph.stage(input_a, input_b)
            out = self._graph.replay(self._graph.decide_rebuild())
        self.silenced = self.silenced + out.silenced
        self.rebuilds += int(out.rebuilt)
        return out

    def process_input_buffers(self, input_a, input_b):
        """One hop. Returns (out_a, out_b, out_a_t, out_b_t), each
        (ranks, hop, srcs), or None for a disabled zone. The whole call is
        the hop meter's ``entry`` span."""
        t0 = _meter.enter()
        out = self._kept(self._advance(input_a, input_b))
        v = self._num_outputs
        feeds = (
            out.out_a,
            out.out_b,
            out.out_a_t.expand(v, *out.out_a_t.shape),
            out.out_b_t.expand(v, *out.out_b_t.shape),
        )
        _meter.leave(t0, out.rebuilt)
        return feeds

    def process_signals(self, signal_a, signal_b):
        """All whole hops of two program signals, hop by hop. Returns
        stitched signals (ranks, T, srcs) per field (None for disabled
        zones)."""
        signal_a, signal_b = self._signal(signal_a), self._signal(signal_b)
        hop = self.config.hop
        num_hops = min(signal_a.shape[0], signal_b.shape[0]) // hop
        outs = [
            self._kept(self._step(signal_a[i * hop : (i + 1) * hop],
                                  signal_b[i * hop : (i + 1) * hop]))
            for i in range(num_hops)
        ]
        v = self._num_outputs

        def stitch(name):
            if getattr(outs[0], name) is None:
                return None
            return stitch_outputs(torch.stack([getattr(o, name) for o in outs]))

        def stitch_target(name):  # (hops, hop, s) -> (v, T, s)
            flat = torch.cat([getattr(o, name) for o in outs])
            return flat.expand(v, *flat.shape)

        return stitch("out_a"), stitch("out_b"), stitch_target("out_a_t"), stitch_target("out_b_t")

    def process_hops_span(self, window_a, window_b, span_index: int = -1, pcm: bool = False):
        """Serving drain: n whole hops from one upload of the two stacked
        windows, one rank's loudspeaker feeds (``span_index``) selected and
        packed side by side on the device, one fetch.

        ``pcm=True`` quantizes the feeds on the device to block-scaled
        int16 (one scale for the batch, 32766 over its peak, bitcast into
        the first row) and dequantizes them on the host, halving the bytes
        fetched. Returns (feeds_a, feeds_b), NumPy float32 (n * hop, srcs)
        each (the config's dtype without ``pcm``), or None for a disabled
        zone. With ``pcm=False`` they equal, bit for bit, the feeds of n
        calls of :meth:`process_input_buffers`."""
        cfg = self.config
        np_dtype = np.dtype(cfg.dtype)
        window_a = np.asarray(window_a, dtype=np_dtype).reshape(-1)
        window_b = np.asarray(window_b, dtype=np_dtype).reshape(-1)
        hop = cfg.hop
        n = window_a.shape[0] // hop
        if n * hop != window_a.shape[0] or window_a.shape != window_b.shape:
            raise ValueError("windows must be equal whole-hop lengths")
        cuda = self.device.type == "cuda"
        windows = torch.from_numpy(np.stack([window_a, window_b]))
        if cuda:
            windows = windows.pin_memory()
        windows = windows.to(self.device, non_blocking=True)
        zones = [z for z, run in (("out_a", cfg.run_a), ("out_b", cfg.run_b)) if run]
        s = cfg.num_srcs
        feeds = torch.empty((n * hop, len(zones) * s), dtype=windows.dtype, device=self.device)
        for i in range(n):
            rows = slice(i * hop, (i + 1) * hop)
            out = self._step(windows[0, rows], windows[1, rows])
            for k, name in enumerate(zones):
                feeds[rows, k * s : (k + 1) * s] = getattr(out, name)[span_index]
        packed = feeds
        if pcm:
            peak = feeds.abs().max()
            scale = 32766.0 / peak.clamp_min(torch.finfo(torch.float32).tiny)
            q = torch.round(feeds * scale).to(torch.int16)
            if q.shape[1] < 2:
                # The scale row needs two int16 slots: a one-column feed
                # gets a zero column, which the unpack below ignores.
                q = torch.nn.functional.pad(q, (0, 2 - q.shape[1]))
            srow = torch.zeros((1, q.shape[1]), dtype=torch.int16, device=self.device)
            srow[0, :2] = scale.float().reshape(1).view(torch.int16)
            packed = torch.cat([srow, q])
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=cuda)
        host.copy_(packed, non_blocking=True)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        arr = host.numpy()
        if pcm:
            scale = np.frombuffer(arr[0, :2].tobytes(), np.float32)[0]
            arr = arr[1:].astype(np.float32) * (1.0 / scale)
        fa = arr[:, :s] if cfg.run_a else None
        fb = arr[:, s if cfg.run_a else 0 :][:, :s] if cfg.run_b else None
        return fa, fb
