"""The time-domain engine: plan, state, hop transition, stream driver."""

from apvast_torch.engine.hop import HopOutputs, hop_statistics, process_hop
from apvast_torch.engine.plan import ApVastPlan, build_plan
from apvast_torch.engine.state import ApVastState, init_state
from apvast_torch.engine.stream import run_stream, stitch_outputs

__all__ = [
    "ApVastPlan",
    "ApVastState",
    "HopOutputs",
    "build_plan",
    "hop_statistics",
    "init_state",
    "process_hop",
    "run_stream",
    "stitch_outputs",
]
