"""Serve many independent scenes in one hop (port of
``apvast_tpu/models/multi_scene.py::MultiSceneApVast``).

A batch of two-zone scenes (other rooms, other programs) that share one
configuration advances in lockstep: the hop ``torch.func.vmap``-ed over a
leading scene axis (``parallel/mesh.py``), each kernel launched once a
hop for all scenes. On the card the batched hop runs as a CUDA graph per
rebuild branch where the configuration allows (``models/base.py``), as the
JAX package jit-compiles its vmapped hop once. Given a mesh, each rank of
the ``torch.distributed`` process group serves its block of the scenes and
microphones, eagerly.
"""

from __future__ import annotations

import torch

from apvast_torch.config import ApVastConfig
from apvast_torch.engine.hop import HopOutputs
from apvast_torch.engine.plan import build_plan
from apvast_torch.engine.state import init_state
from apvast_torch.models.base import GraphDispatch
from apvast_torch.observability import meter
from apvast_torch.parallel.mesh import (
    Mesh,
    check_mesh,
    scene_block,
    shard_plan,
    shard_scene_batch,
    sharded_multi_scene_hop,
    stack_plans,
    stack_states,
)
from apvast_torch.utils.device import resolve_device, torch_dtype

_meter = meter()


class MultiSceneApVast(GraphDispatch):
    """A batch of AP-VAST streams with one shared config.

    Args:
        config: shared scene geometry and hyperparameters.
        rir_pairs: one (rir_a, rir_b) pair a scene, each
            (rir_length, num_srcs, num_mics).
        device: ``"cuda"`` unless given (raises without a card).
        generators: one ``torch.Generator`` a scene, which draws its
            initial response noise and subspace basis
            (``engine.state.init_state``); default scene i's seeded with i.
        graph: as for ``ApVast`` (:class:`~apvast_torch.models.base.GraphDispatch`).
        mesh: a :class:`~apvast_torch.parallel.mesh.Mesh` with ``scene``
            and/or ``mic`` dimensions, or None. With a mesh this rank holds
            its block of the scenes and microphones
            (``parallel.mesh.shard_plan``, ``shard_scene_batch``), takes
            every scene's inputs and returns its own scenes' outputs
            (``parallel.mesh.gather_blocks`` puts the ranks' blocks
            together); the hop runs eagerly.

    Lockstep: the tracking solver's rebuild cadence and its hop counter
    are one host value for all scenes, and the rebuild decision is one for
    all of them (the largest residual over the scenes, a rank's own with
    a mesh), so every scene advances together. 'newton' decides per scene
    on the device. A capture, replay or vmap failure raises: the hop never
    runs scene by scene or on the CPU in its place.
    """

    _batched = True

    def __init__(self, config: ApVastConfig, rir_pairs, device=None, generators=None,
                 graph: bool | None = None, mesh: Mesh | None = None):
        check_mesh(config, mesh)
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self._num_scenes = len(rir_pairs)
        with _meter.setup_span("plan"):
            plan = stack_plans([build_plan(config, ra, rb, self.device) for ra, rb in rir_pairs])
        self.plan = plan if mesh is None else shard_plan(plan, mesh)
        self._hop = sharded_multi_scene_hop(config, mesh)
        self._init_dispatch(graph)
        self.reset(generators)

    def reset(self, generators=None) -> None:
        """Fresh states for every scene, drawn from ``generators`` (one a
        scene; default scene i's seeded with i); ``silenced`` and
        ``rebuilds`` restart at 0."""
        n = self._num_scenes
        if generators is None:
            generators = [torch.Generator().manual_seed(i) for i in range(n)]
        if len(generators) != n:
            raise ValueError(f"{len(generators)} generators for {n} scenes")
        state = stack_states([init_state(self.config, self.device, generator=g)
                              for g in generators])
        self.state = state if self.mesh is None else shard_scene_batch(state, self.mesh)
        # Non-finite solver outputs summed over every hop since the reset,
        # (this rank's scenes,) int32 on the device.
        self.silenced = torch.zeros(self.state.input_blocks.shape[0], dtype=torch.int32,
                                    device=self.device)
        # Hops that rebuilt (tracking: one decision for the scenes); 'newton'
        # counts per scene, an int32 tensor on the device.
        self.rebuilds = 0

    @property
    def plans(self):
        """The batched plan (``parallel.mesh``: scene fields stacked; this
        rank's block with a mesh)."""
        return self.plan

    @property
    def states(self):
        """The batched state (:attr:`state`)."""
        return self.state

    @states.setter
    def states(self, value) -> None:
        self.state = value

    @property
    def num_scenes(self) -> int:
        """All scenes of the batch (a mesh's ranks hold blocks of them)."""
        return self._num_scenes

    def check_lockstep(self) -> None:
        """Kept for the JAX package's API: there it checks that the scenes'
        stacked hop counters agree. Here the scenes share one host counter
        (``parallel.mesh.stack_states`` refuses states whose counters
        differ), so they are in lockstep by construction."""

    def process_input_buffers(self, hops_a, hops_b) -> HopOutputs:
        """Advance every scene one hop. ``hops_a`` / ``hops_b``:
        (num_scenes, hop). Returns HopOutputs with a leading scene axis
        (fresh tensors; ``rebuilt`` one host bool for the scenes, or per
        scene for 'newton'); with a mesh, this rank's scenes'. The whole
        call is the hop meter's ``entry`` span."""
        t0 = _meter.enter()
        hops_a, hops_b = torch.as_tensor(hops_a), torch.as_tensor(hops_b)
        expected = (self.num_scenes, self.config.hop)
        if tuple(hops_a.shape) != expected or tuple(hops_b.shape) != expected:
            raise ValueError(f"hop batches must be {expected}")
        hops_a, hops_b = scene_block(hops_a, self.mesh), scene_block(hops_b, self.mesh)
        if self._graph is None:
            dtype = torch_dtype(self.config)
            self._state, out = self._hop(self.plan, self._state,
                                         hops_a.to(self.device, dtype), hops_b.to(self.device, dtype))
        else:
            self._graph.stage(hops_a, hops_b)
            out = self._kept(self._graph.replay(self._graph.decide_rebuild()))
        self.silenced = self.silenced + out.silenced
        if isinstance(out.rebuilt, torch.Tensor):
            self.rebuilds = self.rebuilds + out.rebuilt.to(torch.int32)
        else:
            self.rebuilds += int(out.rebuilt)
        _meter.leave(t0, out.rebuilt)
        return out
