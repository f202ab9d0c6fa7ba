"""AP-VAST in PyTorch, with the TPU package's Pallas kernels rewritten by
hand for NVIDIA Hopper (``csrc/*.cu``).

The layout mirrors ``apvast_tpu/``. Entry points run on ``"cuda"`` unless
the caller passes ``device="cpu"``; this package imports ``torch``, NumPy
and SciPy, and nothing of JAX or of ``apvast_tpu``.
"""

from apvast_torch.config import (
    ApVastConfig,
    GevdSolver,
    production_overrides,
)
from apvast_torch.engine import (
    HopOutputs,
    build_plan,
    init_state,
    process_hop,
    run_multi_stream,
    run_stream,
    stitch_outputs,
)
from apvast_torch.models import ApVast, ApVastFD, MultiSceneApVast, vast_offline
from apvast_torch.runtime import StreamHost

__all__ = [
    "ApVast",
    "ApVastConfig",
    "ApVastFD",
    "GevdSolver",
    "HopOutputs",
    "MultiSceneApVast",
    "StreamHost",
    "build_plan",
    "init_state",
    "process_hop",
    "production_overrides",
    "run_multi_stream",
    "run_stream",
    "stitch_outputs",
    "vast_offline",
]
