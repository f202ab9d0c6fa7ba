"""The scene-batched hop (port of the ``mesh=None`` part of
``apvast_tpu/parallel/mesh.py``): N independent scenes that share one
configuration advance in lockstep, the hop ``torch.func.vmap``-ed over a
leading scene axis as the JAX package's is ``jax.vmap(process_hop)``. Each
kernel folds the scene axis into its own leading batch axis
(``ops/kernels/_batch.py``), so it launches once a hop for all scenes.

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

The tracking solver's rebuild decision is one host bool for all scenes,
as in the JAX package (``parallel/mesh.py:233-258``): the warmup and the
cadence of the shared counter, or the largest of the scenes' residuals
above ``tracking_residual_rebuild`` (one device read on the hops that need
it). A per-scene decision would rebuild every scene every hop, as vmap's
``lax.cond`` lowers to a select of both branches.
"""

from __future__ import annotations

import dataclasses

import torch

from apvast_torch.config import ApVastConfig, uses_subspace_solver, uses_tracking_solver
from apvast_torch.engine.fd_hop import process_hop_fd
from apvast_torch.engine.hop import HopOutputs, process_hop, rebuild_predicate
from apvast_torch.engine.plan import ApVastPlan

# The plan fields that differ between scenes; the rest are shared.
SCENE_PLAN_FIELDS = ("rir_spec", "target_rir_spec", "conv_kernels")

_MESH = ("a mesh (scene or microphone sharding over several cards) is ROADMAP.md Queue 1 "
         "item 7; the port batches scenes on one card (mesh=None)")
_NEWTON = (
    "subspace_whiten='newton' cannot be batched over scenes: its rebuild decision reads the "
    "carried inverse's residual from the device mid-hop (ops/jdiag.py), one decision a scene, "
    "which the JAX package's vmapped lax.cond lowers to a per-scene select of both branches; "
    "one decision for all scenes would compute something else"
)


def check_batched(config: ApVastConfig, mesh=None) -> None:
    """Raise ValueError for what the scene-batched hop does not serve: a
    mesh, and the 'newton' solver."""
    if mesh is not None:
        raise ValueError(_MESH)
    if uses_subspace_solver(config) and config.subspace_whiten == "newton":
        raise ValueError(_NEWTON)


def _split(obj) -> tuple[dict, dict]:
    """A dataclass's fields as (tensors, everything else)."""
    tensors, rest = {}, {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        (tensors if isinstance(value, torch.Tensor) else rest)[f.name] = value
    return tensors, rest


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
    hop counter) and an output's (``rebuilt``, a disabled zone's None) are
    one value for all scenes."""
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


def sharded_multi_scene_hop(config: ApVastConfig, mesh=None):
    """The time-domain hop over a leading scene axis: a function
    ``hop(plans, states, hops_a, hops_b, rebuild_override=None) -> (states,
    HopOutputs)`` of a batched plan and state (module docstring) and
    (N, hop) inputs, whose outputs carry a leading scene axis (``rebuilt``
    is one host bool). The tracking solver's rebuild decision is one for
    all scenes: ``rebuild_predicate`` on the shared hop counter, with the
    largest residual over scenes and zones read from the device only on the
    hops that need it; ``rebuild_override`` replaces it. ``mesh`` must be
    None (the JAX package's ``jit(vmap(hop))``); 'newton' raises
    ValueError."""
    check_batched(config, mesh)

    def hop(plans, states, hops_a, hops_b, rebuild_override=None):
        rebuild = rebuild_override
        if rebuild is None and uses_tracking_solver(config):
            rebuild = rebuild_predicate(config, states.gevd_hop,
                                        lambda: states.gevd_resid.max().item())
        return _vmap_hop(
            lambda p, s, a, b: process_hop(config, p, s, a, b, rebuild_override=rebuild),
            plans, states, hops_a, hops_b)

    return hop


def sharded_multi_scene_fd_hop(config: ApVastConfig, mesh=None, forgetting: float = 0.9):
    """The frequency-domain hop over a leading scene axis:
    ``hop(plans, states, hops_a, hops_b) -> (states, HopOutputs)``, as
    :func:`sharded_multi_scene_hop` (``rebuild_override`` is taken and
    ignored: the FD engine has no rebuild); ``mesh`` must be None."""
    check_batched(config, mesh)

    def hop(plans, states, hops_a, hops_b, rebuild_override=None):
        return _vmap_hop(
            lambda p, s, a, b: process_hop_fd(config, p, s, a, b, forgetting=forgetting),
            plans, states, hops_a, hops_b)

    return hop
