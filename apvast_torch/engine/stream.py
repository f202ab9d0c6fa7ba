"""Offline stream drivers (port of ``apvast_tpu/engine/stream.py``:
``run_stream`` and ``run_multi_stream``): the hop transition in a Python
loop in place of ``lax.scan``."""

from __future__ import annotations

import torch

from apvast_torch.config import ApVastConfig
from apvast_torch.engine.hop import HopOutputs, process_hop
from apvast_torch.engine.plan import ApVastPlan
from apvast_torch.engine.state import ApVastState


def run_stream(
    config: ApVastConfig,
    plan: ApVastPlan,
    state: ApVastState,
    signal_a: torch.Tensor,
    signal_b: torch.Tensor,
) -> tuple[ApVastState, HopOutputs]:
    """Process whole program signals hop by hop.

    ``signal_a`` / ``signal_b``: (num_hops * hop,); a trailing partial hop
    is dropped. Returns the final state and HopOutputs with a leading
    ``num_hops`` axis on every field (None fields stay None; ``rebuilt``
    becomes a bool tensor).
    """
    hop = config.hop
    num_hops = min(signal_a.shape[0], signal_b.shape[0]) // hop
    hops_a = signal_a[: num_hops * hop].reshape(num_hops, hop)
    hops_b = signal_b[: num_hops * hop].reshape(num_hops, hop)
    per_hop = []
    for i in range(num_hops):
        state, out = process_hop(config, plan, state, hops_a[i], hops_b[i])
        per_hop.append(out)
    return state, _stacked(per_hop)


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
    scenes).

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
        return torch.tensor(vals) if name == "rebuilt" else torch.stack(vals)

    fields = ("out_a", "out_b", "out_a_t", "out_b_t", "silenced", "rebuilt")
    return HopOutputs(**{f: stacked(f) for f in fields})


def stitch_outputs(stacked: torch.Tensor) -> torch.Tensor:
    """(num_hops, v, hop, srcs) -> (v, num_hops * hop, srcs)."""
    num_hops, v, hop, srcs = stacked.shape
    return stacked.permute(1, 0, 2, 3).reshape(v, num_hops * hop, srcs)
