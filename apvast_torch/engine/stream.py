"""Offline stream driver (port of ``apvast_tpu/engine/stream.py::run_stream``):
the hop transition in a Python loop in place of ``lax.scan``."""

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
    ``num_hops`` axis on every field (None fields stay None).
    """
    hop = config.hop
    num_hops = min(signal_a.shape[0], signal_b.shape[0]) // hop
    hops_a = signal_a[: num_hops * hop].reshape(num_hops, hop)
    hops_b = signal_b[: num_hops * hop].reshape(num_hops, hop)
    per_hop = []
    for i in range(num_hops):
        state, out = process_hop(config, plan, state, hops_a[i], hops_b[i])
        per_hop.append(out)

    def stacked(name):
        vals = [getattr(o, name) for o in per_hop]
        return None if vals[0] is None else torch.stack(vals)

    fields = ("out_a", "out_b", "out_a_t", "out_b_t", "silenced")
    return state, HopOutputs(**{f: stacked(f) for f in fields})


def stitch_outputs(stacked: torch.Tensor) -> torch.Tensor:
    """(num_hops, v, hop, srcs) -> (v, num_hops * hop, srcs)."""
    num_hops, v, hop, srcs = stacked.shape
    return stacked.permute(1, 0, 2, 3).reshape(v, num_hops * hop, srcs)
