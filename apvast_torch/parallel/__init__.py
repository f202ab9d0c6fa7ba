"""Scene batching on one card and sharding over ranks (the JAX package's
``parallel`` layer): ``parallel/mesh.py``."""

from apvast_torch.parallel.mesh import (
    SCENE_PLAN_FIELDS,
    Mesh,
    gather_blocks,
    make_mesh,
    scene_block,
    shard_fd_state,
    shard_plan,
    shard_scene_batch,
    sharded_multi_scene_fd_hop,
    sharded_multi_scene_hop,
)

__all__ = [
    "SCENE_PLAN_FIELDS",
    "Mesh",
    "gather_blocks",
    "make_mesh",
    "scene_block",
    "shard_fd_state",
    "shard_plan",
    "shard_scene_batch",
    "sharded_multi_scene_fd_hop",
    "sharded_multi_scene_hop",
]
