"""Offline stream drivers (port of ``apvast_tpu/engine/stream.py``:
``run_stream``, ``run_stream_with_metrics`` and ``run_multi_stream``): the
hop transition in a Python loop in place of ``lax.scan``; on the card the
single-stream drivers replay the hop as a CUDA graph (``engine/graph.py``),
as the models do, where the configuration allows."""

from __future__ import annotations

import dataclasses

import torch

from apvast_torch.config import ApVastConfig
from apvast_torch.engine.graph import GraphedHop, capture, clone_state, graph_reason
from apvast_torch.engine.hop import HopOutputs, process_hop
from apvast_torch.engine.plan import ApVastPlan
from apvast_torch.engine.state import ApVastState
from apvast_torch.observability import HopMetrics, hop_metrics


def _drive(config, plan, state, signal_a, signal_b, each_hop=None, on_hop=None):
    """The hop over whole signals: as a replayed CUDA graph on the card
    where the configuration allows (``engine.graph.graph_reason``), else
    eagerly. Returns the final state, the per-hop outputs and
    ``each_hop(outputs)`` of every hop, computed outside the hop's graph:
    graphed, as a second graph on the hop graph's static outputs, replayed
    after it. ``on_hop()`` is called on the host after each hop (a
    timer's stamp)."""
    hop = config.hop
    num_hops = min(signal_a.shape[0], signal_b.shape[0]) // hop
    hops_a = signal_a[: num_hops * hop].reshape(num_hops, hop)
    hops_b = signal_b[: num_hops * hop].reshape(num_hops, hop)
    graphed = graph_reason(config, plan.window.device) is None
    replayed = GraphedHop(config, plan, state) if graphed else None
    if replayed is not None and each_hop is not None:
        after, after_out = capture(lambda: each_hop(replayed.out), plan.window.device)
    per_hop, extra = [], []
    for i in range(num_hops):
        if replayed is None:
            state, out = process_hop(config, plan, state, hops_a[i], hops_b[i])
            if each_hop is not None:
                extra.append(each_hop(out))
        else:
            replayed.stage(hops_a[i], hops_b[i])
            out = replayed.replay(replayed.decide_rebuild())
            # Both graphs' outputs are static buffers that the next replay
            # overwrites.
            out = clone_state(out)
            if each_hop is not None:
                after.replay()
                extra.append(clone_state(after_out))
        per_hop.append(out)
        if on_hop is not None:
            on_hop()
    if replayed is not None:
        state = clone_state(replayed.state)
    return state, per_hop, extra


def run_stream(
    config: ApVastConfig,
    plan: ApVastPlan,
    state: ApVastState,
    signal_a: torch.Tensor,
    signal_b: torch.Tensor,
) -> tuple[ApVastState, HopOutputs]:
    """Process whole program signals hop by hop.

    ``signal_a`` / ``signal_b``: (num_hops * hop,); a trailing partial hop
    is dropped. On the card the hop is replayed as a CUDA graph where the
    configuration allows (``engine.graph.eager_reason``), as the models do.
    The given state is not changed. Returns the final state and HopOutputs
    with a leading ``num_hops`` axis on every field (None fields stay None;
    ``rebuilt`` becomes a bool tensor).
    """
    state, per_hop, _ = _drive(config, plan, state, signal_a, signal_b)
    return state, _stacked(per_hop)


def run_stream_with_metrics(
    config: ApVastConfig,
    plan: ApVastPlan,
    state: ApVastState,
    signal_a: torch.Tensor,
    signal_b: torch.Tensor,
    rir_a,
    rir_b,
):
    """:func:`run_stream` plus :func:`apvast_torch.observability.hop_metrics`
    of every hop (contrast, NMSE and RMS per span), computed on the device
    outside the captured hop, with no host read of its own.

    Returns (final_state, outputs, metrics), every metrics field with a
    leading ``num_hops`` axis, on the plan's device.
    """
    device, dtype = plan.window.device, plan.window.dtype
    rir_a = torch.as_tensor(rir_a).to(device=device, dtype=dtype)
    rir_b = torch.as_tensor(rir_b).to(device=device, dtype=dtype)
    state, per_hop, metrics = _drive(
        config, plan, state, signal_a, signal_b, lambda out: hop_metrics(out, rir_a, rir_b),
    )
    stacked = HopMetrics(**{
        f.name: torch.stack([getattr(m, f.name) for m in metrics])
        for f in dataclasses.fields(HopMetrics)
    })
    return state, _stacked(per_hop), stacked


def run_multi_stream(
    config: ApVastConfig,
    plans: ApVastPlan,
    states: ApVastState,
    signals_a: torch.Tensor,
    signals_b: torch.Tensor,
) -> tuple[ApVastState, HopOutputs]:
    """Batched serving streams: a loop over hops of the scene-batched hop
    (``parallel.mesh.sharded_multi_scene_hop``, vmap inside).

    ``plans`` / ``states``: a batched plan and state (scene axis leading,
    ``parallel.mesh.stack_plans`` / ``stack_states``); ``signals_*``:
    (scenes, num_hops * hop), a trailing partial hop dropped. Returns the
    final state and HopOutputs with leading (num_hops, scenes) axes
    (``rebuilt`` a (num_hops,) bool tensor, one decision a hop for all
    scenes; 'newton' decides per scene: (num_hops, scenes)).

    The tracking solver's rebuild is decided once a hop for all scenes,
    as in the JAX package: the cadence from the shared hop counter, the
    residual trigger from the largest residual over scenes (any stale
    scene rebuilds all), read from the device only on the hops that need
    it; so every hop runs one branch, not a per-scene select of both."""
    from apvast_torch.parallel.mesh import sharded_multi_scene_hop

    hop_fn = sharded_multi_scene_hop(config)
    hop = config.hop
    num_hops = min(signals_a.shape[1], signals_b.shape[1]) // hop
    per_hop = []
    for i in range(num_hops):
        rows = slice(i * hop, (i + 1) * hop)
        states, out = hop_fn(plans, states, signals_a[:, rows], signals_b[:, rows])
        per_hop.append(out)
    return states, _stacked(per_hop)


def _stacked(per_hop: list[HopOutputs]) -> HopOutputs:
    """Per-hop outputs stacked on a leading hop axis (None fields stay
    None; ``rebuilt`` becomes a bool tensor)."""

    def stacked(name):
        vals = [getattr(o, name) for o in per_hop]
        if vals[0] is None:
            return None
        if not isinstance(vals[0], torch.Tensor):  # a host decision a hop
            return torch.tensor(vals)
        return torch.stack(vals)

    fields = ("out_a", "out_b", "out_a_t", "out_b_t", "silenced", "rebuilt")
    return HopOutputs(**{f: stacked(f) for f in fields})


def stitch_outputs(stacked: torch.Tensor) -> torch.Tensor:
    """(num_hops, v, hop, srcs) -> (v, num_hops * hop, srcs)."""
    num_hops, v, hop, srcs = stacked.shape
    return stacked.permute(1, 0, 2, 3).reshape(v, num_hops * hop, srcs)
