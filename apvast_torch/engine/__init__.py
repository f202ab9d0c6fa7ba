"""The engines: plan, time-domain state, hop transition and stream driver,
and the frequency-domain hop."""

from apvast_torch.engine.fd_hop import FdState, init_fd_state, process_hop_fd
from apvast_torch.engine.graph import GraphedHop, eager_reason, hop_into
from apvast_torch.engine.hop import HopOutputs, hop_statistics, process_hop
from apvast_torch.engine.plan import ApVastPlan, build_plan
from apvast_torch.engine.state import ApVastState, SubspaceState, TrackingState, init_state
from apvast_torch.engine.stream import (
    run_multi_stream,
    run_stream,
    run_stream_with_metrics,
    stitch_outputs,
)

__all__ = [
    "ApVastPlan",
    "ApVastState",
    "FdState",
    "GraphedHop",
    "HopOutputs",
    "SubspaceState",
    "TrackingState",
    "build_plan",
    "eager_reason",
    "hop_into",
    "hop_statistics",
    "init_fd_state",
    "init_state",
    "process_hop",
    "process_hop_fd",
    "run_multi_stream",
    "run_stream",
    "run_stream_with_metrics",
    "stitch_outputs",
]
