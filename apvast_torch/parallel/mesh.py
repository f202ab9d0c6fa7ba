"""Scene batching and sharding (port of ``apvast_tpu/parallel/mesh.py``).

*Scene batching.* N independent scenes that share one configuration
advance in lockstep, the hop ``torch.func.vmap``-ed over a leading scene
axis as the JAX package's is ``jax.vmap(process_hop)``. Each kernel folds
the scene axis into its own leading batch axis (``ops/kernels/_batch.py``),
so it launches once a hop for all scenes.

A batched plan is an :class:`~apvast_torch.engine.plan.ApVastPlan` whose
per-scene fields (:data:`SCENE_PLAN_FIELDS`: the RIR spectra and K1's
kernel rows) carry a leading scene axis. Every other field is computed
from the configuration alone (the window, the DFT matrices, the target
filters, the perceptual tables) and stays unbatched, shared by all scenes
(vmap's ``in_dims`` None): a shared DFT matrix makes one matmul over N
scenes' rows, not N copies of it. The JAX package stacks every field; the
numbers are the same. A batched state carries the scene axis on every
tensor; the tracking solver's hop counter ``gevd_hop`` stays one host int
for all scenes, so they stay in lockstep by construction.

The tracking solver's rebuild decision is one host bool for the scenes of
a hop, as in the JAX package (``parallel/mesh.py:233-258``): the warmup
and the cadence of the shared counter, or the largest of the scenes'
residuals above ``tracking_residual_rebuild`` (one device read on the hops
that need it). 'newton' decides per scene on the device, a select of both
branches (``ops/jdiag.py::jdiag_topk_pencil_batched``), as the JAX
package's vmapped ``lax.cond`` lowers.

*Sharding* (the counterpart of ``jax.sharding.Mesh`` + ``shard_map`` +
``psum``). A :class:`Mesh` names the ranks of the default
``torch.distributed`` process group as a grid with a ``scene`` and/or a
``mic`` dimension. Each rank runs the single-device batched hop on its
block: its scenes (by its ``scene`` coordinate) and its microphones (by
its ``mic`` coordinate), and the hop's one collective sums the partial
statistics over the ranks of its mic group (``ops/collective.py``).
Everything after that sum runs alike on every rank of a mic group, which
so hold the same filters and take the same rebuild decisions; the scene
groups never communicate, and each decides from its own scenes, as
JAX's per-device ``shard_map`` program does. :func:`shard_plan`,
:func:`shard_scene_batch` and :func:`shard_fd_state` cut a rank's block
out of whole batches; :func:`gather_blocks` puts blocks back together.
The sharded hop runs eagerly (gloo collectives cannot be captured in a
CUDA graph).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from apvast_torch.config import ApVastConfig, uses_tracking_solver
from apvast_torch.engine.fd_hop import FdState, process_hop_fd
from apvast_torch.engine.hop import HopOutputs, process_hop, rebuild_predicate
from apvast_torch.engine.plan import ApVastPlan
from apvast_torch.ops.collective import host_staged

# The plan fields that differ between scenes; the rest are shared.
SCENE_PLAN_FIELDS = ("rir_spec", "target_rir_spec", "conv_kernels")

# The microphone dimension of each field that has one, unbatched (JAX's
# _STATE_MIC_DIM, _PLAN_MIC_DIM, _FD_STATE_MIC_DIM); every other field is
# the same on every rank of a mic group. K1's kernel rows fold every
# microphone, so a mic-sharded hop refuses K1, as JAX's does.
_STATE_MIC_DIM = {
    "resp": 1,
    "target_resp": 1,
    "wresp_overlap": 1,
    "wtarget_overlap": 1,
    "wresp_stat": 1,
    "wtarget_stat": 1,
}
_PLAN_MIC_DIM = {"rir_spec": 1, "target_rir_spec": 1}
# The FD engine's recursion carries microphone-summed statistics.
_FD_STATE_MIC_DIM = {"resp": 1, "target_resp": 1, "spec_hist": 2}  # (B-1, 4, m, s, bins)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The default process group's ranks as a named grid (``shape``, e.g.
    ``{"scene": 2, "mic": 4}``, the last dimension fastest), over a
    ``torch.distributed`` device mesh whose groups serve tensors on any
    device: it moves nothing."""

    shape: dict
    device_mesh: object

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for a dimension the mesh lacks)."""
        return self.shape.get(axis, 1)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for a dimension the mesh
        lacks)."""
        return self.device_mesh.get_local_rank(axis) if axis in self.shape else 0

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``, or None
        for a dimension the mesh lacks."""
        return self.device_mesh.get_group(axis) if axis in self.shape else None


def make_mesh(shape: dict[str, int]) -> Mesh:
    """A mesh over the initialized default process group, e.g.
    ``make_mesh({"scene": 2, "mic": 4})`` on 8 ranks; raises ValueError
    when the grid's size is not the group's."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialized default process group "
                         "(torch.distributed.init_process_group)")
    total = 1
    for size in shape.values():
        total *= size
    if total != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {total} ranks, the process group has "
                         f"{dist.get_world_size()}")
    # Device type "cpu": the groups' backend (gloo) takes CUDA tensors as well.
    return Mesh(dict(shape), init_device_mesh("cpu", tuple(shape.values()),
                                              mesh_dim_names=tuple(shape)))


def check_mesh(config: ApVastConfig, mesh: Mesh | None, mic_axis: str = "mic") -> None:
    """Raise ValueError where the microphones do not split evenly over the
    mesh's ``mic_axis`` (as JAX's ``shard_map`` does)."""
    if mesh is not None and config.num_mics % mesh.size(mic_axis):
        raise ValueError(f"num_mics={config.num_mics} does not split over the "
                         f"{mesh.size(mic_axis)} ranks of mesh axis {mic_axis!r}")


def _split(obj) -> tuple[dict, dict]:
    """A dataclass's fields as (tensors, everything else)."""
    tensors, rest = {}, {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        (tensors if isinstance(value, torch.Tensor) else rest)[f.name] = value
    return tensors, rest


def _layout(obj, batched: bool):
    """``(scene_fields, mic_dims)`` of a plan, state or output dataclass:
    the tensor fields that carry a leading scene axis, and each field's
    microphone dimension in the tensor as it is (after its scene axis)."""
    tensors, _ = _split(obj)
    if isinstance(obj, ApVastPlan):
        table = _PLAN_MIC_DIM
        scene = set(SCENE_PLAN_FIELDS) if batched else set()
    else:
        table = (_FD_STATE_MIC_DIM if isinstance(obj, FdState)
                 else {} if isinstance(obj, HopOutputs) else _STATE_MIC_DIM)
        scene = set(tensors) if batched else set()
    mic = {name: dim + (name in scene) for name, dim in table.items() if name in tensors}
    return scene, mic


def _block(obj, mesh: Mesh, scene_axis: str, mic_axis: str, batched: bool):
    scene, mic = _layout(obj, batched)
    tensors, rest = _split(obj)
    out = {}
    for name, t in tensors.items():
        for axis, dim in ((scene_axis, 0 if name in scene else None), (mic_axis, mic.get(name))):
            if dim is None or axis not in mesh.shape:
                continue
            size = mesh.size(axis)
            if t.shape[dim] % size:
                raise ValueError(f"{name}: its {t.shape[dim]} entries along dim {dim} do "
                                 f"not split over the {size} ranks of mesh axis {axis!r}")
            n = t.shape[dim] // size
            t = t.narrow(dim, mesh.coordinate(axis) * n, n)
        out[name] = t.contiguous()
    return type(obj)(**out, **rest)


def shard_plan(plan, mesh: Mesh, scene_axis: str = "scene", mic_axis: str = "mic",
               batched: bool = True):
    """This rank's block of a plan (scene-batched unless ``batched`` is
    False): its scenes of the :data:`SCENE_PLAN_FIELDS` and its
    microphones of the fields that have them; the shared fields as they
    are."""
    return _block(plan, mesh, scene_axis, mic_axis, batched)


def shard_scene_batch(state, mesh: Mesh, scene_axis: str = "scene", mic_axis: str = "mic",
                      batched: bool = True):
    """This rank's block of a time-domain state (scene-batched unless
    ``batched`` is False): its scenes, and its microphones of the response
    and statistics buffers."""
    return _block(state, mesh, scene_axis, mic_axis, batched)


def shard_fd_state(state, mesh: Mesh, scene_axis: str = "scene", mic_axis: str = "mic",
                   batched: bool = True):
    """This rank's block of a frequency-domain state (its scenes, and its
    microphones of the response buffers and the frame-tap history; the
    covariance recursion is the same on every rank of a mic group)."""
    return _block(state, mesh, scene_axis, mic_axis, batched)


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``t`` on the ranks of ``group``, concatenated along
    ``dim`` in rank order."""
    x = t.to("cpu") if host_staged(group) else t
    x = x.to(torch.uint8) if x.dtype == torch.bool else x
    x = torch.view_as_real(x) if x.is_complex() else x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    if t.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def gather_blocks(obj, mesh: Mesh, scene_axis: str = "scene", mic_axis: str = "mic",
                  batched: bool = True):
    """The whole batch of a plan, state or :class:`HopOutputs` from every
    rank's block (the inverse of :func:`shard_plan`,
    :func:`shard_scene_batch` and :func:`shard_fd_state`; outputs carry
    the scene axis only). A collective: every rank calls it, and every
    rank gets the whole."""
    scene, mic = _layout(obj, batched)
    tensors, rest = _split(obj)
    out = {}
    for name, t in tensors.items():
        if name in mic and mic_axis in mesh.shape:
            t = _all_gather(t, mesh.group(mic_axis), mic[name])
        if name in scene and scene_axis in mesh.shape and t.dim() > 0:
            t = _all_gather(t, mesh.group(scene_axis), 0)
        out[name] = t
    return type(obj)(**out, **rest)


def scene_block(x: torch.Tensor, mesh: Mesh | None, scene_axis: str = "scene") -> torch.Tensor:
    """This rank's scenes of a (N, ...) batch (all of it without a mesh or
    a scene dimension)."""
    if mesh is None or scene_axis not in mesh.shape:
        return x
    n = x.shape[0] // mesh.size(scene_axis)
    if n * mesh.size(scene_axis) != x.shape[0]:
        raise ValueError(f"{x.shape[0]} scenes do not split over the "
                         f"{mesh.size(scene_axis)} ranks of mesh axis {scene_axis!r}")
    return x[mesh.coordinate(scene_axis) * n : (mesh.coordinate(scene_axis) + 1) * n]


def stack_plans(plans):
    """A batched plan from one plan a scene: the :data:`SCENE_PLAN_FIELDS`
    stacked, every other field scene 0's; raises ValueError where another
    scene's shared field differs (the scenes must share a configuration)."""
    first = plans[0]
    fields = {}
    for f in dataclasses.fields(first):
        values = [getattr(p, f.name) for p in plans]
        if f.name in SCENE_PLAN_FIELDS:
            fields[f.name] = torch.stack(values)
            continue
        if any((v is None) != (values[0] is None)
               or (v is not None and not torch.equal(v, values[0])) for v in values[1:]):
            raise ValueError(f"plan field {f.name} differs between scenes: the scenes of a "
                             "batch must share one configuration")
        fields[f.name] = values[0]
    return type(first)(**fields)


def stack_states(states):
    """A batched state from one state a scene, every tensor stacked;
    raises ValueError where the scenes' host fields differ (the tracking
    solver's ``gevd_hop``: scenes in lockstep share one counter)."""
    tensors, rest = zip(*(_split(s) for s in states))
    for name, value in rest[0].items():
        if any(r[name] != value for r in rest[1:]):
            raise ValueError(f"state field {name} differs between scenes ("
                             f"{sorted({r[name] for r in rest})}): the scenes of a batch "
                             "advance in lockstep; reset all of them together")
    return type(states[0])(**{name: torch.stack([t[name] for t in tensors])
                              for name in tensors[0]}, **rest[0])


def scene_of(batched, i: int):
    """Scene ``i`` of a batched plan or state (views of its tensors; a
    plan's shared fields as they are)."""
    tensors, rest = _split(batched)
    plan = isinstance(batched, ApVastPlan)
    return type(batched)(**{
        name: t[i] if not plan or name in SCENE_PLAN_FIELDS else t
        for name, t in tensors.items()
    }, **rest)


def _vmap_hop(step, plans, states, hops_a, hops_b):
    """``step(plan, state, hop_a, hop_b) -> (state, HopOutputs)`` over the
    leading scene axis of ``states``, ``hops_a`` and ``hops_b`` (N, hop) and
    of the plan's :data:`SCENE_PLAN_FIELDS`. A state's host fields (the
    hop counter) and an output's (the tracking solver's ``rebuilt``, a
    disabled zone's None) are one value for all scenes."""
    plan_t, plan_rest = _split(plans)
    state_t, state_rest = _split(states)
    plan_dims = {name: 0 if name in SCENE_PLAN_FIELDS else None for name in plan_t}
    host = {}

    def single(plan_t, state_t, hop_a, hop_b):
        new, out = step(type(plans)(**plan_t, **plan_rest),
                        type(states)(**state_t, **state_rest), hop_a, hop_b)
        new_t, host["state"] = _split(new)
        out_t, host["out"] = _split(out)
        host["cls"] = type(new)
        return new_t, out_t

    new_t, out_t = torch.func.vmap(single, in_dims=(plan_dims, 0, 0, 0))(
        plan_t, state_t, hops_a, hops_b)
    return host["cls"](**new_t, **host["state"]), HopOutputs(**out_t, **host["out"])


def sharded_multi_scene_hop(config: ApVastConfig, mesh: Mesh | None = None,
                            scene_axis: str = "scene", mic_axis: str = "mic"):
    """The time-domain hop over a leading scene axis: a function
    ``hop(plans, states, hops_a, hops_b, rebuild_override=None) -> (states,
    HopOutputs)`` of a batched plan and state (module docstring) and
    (N, hop) inputs, whose outputs carry a leading scene axis. The
    tracking solver's rebuild decision is one for the scenes
    (``rebuilt`` one host bool): ``rebuild_predicate`` on the shared hop
    counter, with the largest residual over scenes and zones read from the
    device only on the hops that need it; ``rebuild_override`` replaces it.
    'newton' decides per scene on the device (``rebuilt`` (N,) bool).

    ``mesh``: the plans, states and inputs are this rank's block
    (:func:`shard_plan`, :func:`shard_scene_batch`, :func:`scene_block`);
    with a ``mic_axis`` dimension the statistics are summed over the mic
    group; the decisions are this rank's, from its scenes. None: the
    JAX package's ``jit(vmap(hop))``, all scenes and microphones here."""
    check_mesh(config, mesh, mic_axis)
    group = None if mesh is None else mesh.group(mic_axis)

    def hop(plans, states, hops_a, hops_b, rebuild_override=None):
        rebuild = rebuild_override
        if rebuild is None and uses_tracking_solver(config):
            rebuild = rebuild_predicate(config, states.gevd_hop,
                                        lambda: states.gevd_resid.max().item())
        return _vmap_hop(
            lambda p, s, a, b: process_hop(config, p, s, a, b, rebuild_override=rebuild,
                                           mic_axis=group, select_rebuild=True),
            plans, states, hops_a, hops_b)

    return hop


def sharded_multi_scene_fd_hop(config: ApVastConfig, mesh: Mesh | None = None,
                               forgetting: float = 0.9, scene_axis: str = "scene",
                               mic_axis: str = "mic"):
    """The frequency-domain hop over a leading scene axis:
    ``hop(plans, states, hops_a, hops_b) -> (states, HopOutputs)``, as
    :func:`sharded_multi_scene_hop` (``rebuild_override`` is taken and
    ignored: the FD engine has no rebuild); with a mesh, each bin's new
    statistics terms are summed over the mic group."""
    check_mesh(config, mesh, mic_axis)
    group = None if mesh is None else mesh.group(mic_axis)

    def hop(plans, states, hops_a, hops_b, rebuild_override=None):
        return _vmap_hop(
            lambda p, s, a, b: process_hop_fd(config, p, s, a, b, forgetting=forgetting,
                                              mic_axis=group),
            plans, states, hops_a, hops_b)

    return hop
