"""Scene batching on one card (the ``mesh=None`` part of the JAX package's
``parallel`` layer)."""

from apvast_torch.parallel.mesh import (
    SCENE_PLAN_FIELDS,
    sharded_multi_scene_fd_hop,
    sharded_multi_scene_hop,
)

__all__ = [
    "SCENE_PLAN_FIELDS",
    "sharded_multi_scene_fd_hop",
    "sharded_multi_scene_hop",
]
