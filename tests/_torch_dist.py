"""Ranks for the port's sharding tests (``tests/test_torch_sharding.py``).

:func:`spawn` runs a target on several spawned processes joined in a gloo
process group through a file store. A spawned child imports the module
that holds its target, and never runs ``tests/conftest.py``, so the
targets live here and this module imports torch and the port only,
nothing of JAX. Each child runs one torch thread and writes its result
with ``torch.save``; the parent reads them back in rank order.

:func:`scenarios` is the target: from the JAX package's plans and states
(NumPy arrays, passed in by the parent) it runs each sharded scenario of
the test file on a mesh of the ranks and returns, from every rank, the
gathered outputs and states and what each rank decided.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apvast_torch.engine.fd_hop import FdState
from apvast_torch.models import MultiSceneApVast
from apvast_torch.parallel.mesh import (
    gather_blocks,
    make_mesh,
    scene_block,
    shard_fd_state,
    shard_plan,
    shard_scene_batch,
    sharded_multi_scene_fd_hop,
    sharded_multi_scene_hop,
    stack_states,
)
from apvast_torch.utils.convert import fd_state_from_numpy, plans_from_numpy, states_from_numpy


def _entry(rank, target, world, store, outdir, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        result = target(rank, payload)
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(target, world: int, directory, payload, timeout: float = 240.0) -> list:
    """``target(rank, payload)`` on ``world`` spawned ranks of one gloo
    process group (rendezvous: a file store in ``directory``); returns the
    ranks' results in rank order. Raises when a rank fails or the ranks
    outlast ``timeout`` seconds (they are then terminated)."""
    directory = str(directory)
    context = mp.start_processes(
        _entry, args=(target, world, os.path.join(directory, "store"), directory, payload),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@contextlib.contextmanager
def one_rank_group(directory):
    """This process as the one rank of a gloo default process group
    (rendezvous: a file store in ``directory``), destroyed on exit: a mesh
    or mic group of one rank, whose collectives change nothing."""
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(str(directory), 'one')}",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _numpy(obj) -> dict:
    """A dataclass's tensor fields as NumPy arrays (host fields as they are)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.detach().numpy().copy() if isinstance(v, torch.Tensor) else v
    return out


def _td_run(cfg, plans, states, hops, mesh):
    """Hops (H, 2, N, hop) of the sharded TD hop from the whole batched
    ``plans`` and ``states``; returns the gathered outputs and states of
    every hop and this rank's rebuild decisions."""
    fn = sharded_multi_scene_hop(cfg, mesh)
    plan, state = shard_plan(plans, mesh), shard_scene_batch(states, mesh)
    outs, sts, rebuilt = [], [], []
    for x in hops:
        state, out = fn(plan, state, scene_block(x[0], mesh), scene_block(x[1], mesh))
        outs.append(_numpy(gather_blocks(out, mesh)))
        sts.append(_numpy(gather_blocks(state, mesh)))
        rebuilt.append(out.rebuilt)
    return {"outs": outs, "states": sts, "rebuilt": rebuilt}


def _block_reference(cfg, plans, states, hops, mesh, rebuilt):
    """The unsharded batched hop of this rank's scene block, from the same
    block state, with the sharded run's rebuild decisions: its outputs."""
    plan = shard_plan(plans, mesh, mic_axis="none")
    state = shard_scene_batch(states, mesh, mic_axis="none")
    fn = sharded_multi_scene_hop(cfg)
    outs = []
    for x, decision in zip(hops, rebuilt):
        override = decision if isinstance(decision, bool) else None
        state, out = fn(plan, state, scene_block(x[0], mesh), scene_block(x[1], mesh),
                        rebuild_override=override)
        outs.append(_numpy(out))
    return outs


def scenarios(rank, payload) -> dict:
    """Every sharded scenario of ``tests/test_torch_sharding.py`` on 4
    ranks (module docstring)."""
    out = {"rank": rank}
    # Mic and scene sharding together, 3 hops.
    sc = payload["td"]
    cfg = sc["config"]
    plans = plans_from_numpy(cfg, sc["plans"], "cpu")
    states = states_from_numpy(cfg, sc["states"], "cpu")
    hops = torch.from_numpy(sc["hops"])
    mesh = make_mesh({"scene": 2, "mic": 2})
    out["td"] = _td_run(cfg, plans, states, hops, mesh)
    out["coords"] = {"scene": mesh.coordinate("scene"), "mic": mesh.coordinate("mic")}

    # A scene-only mesh, 4 scenes, one a rank, against the unsharded batch
    # of the rank's own scene.
    sc = payload["scene_only"]
    cfg = sc["config"]
    plans = plans_from_numpy(cfg, sc["plans"], "cpu")
    states = states_from_numpy(cfg, sc["states"], "cpu")
    hops = torch.from_numpy(sc["hops"])
    mesh = make_mesh({"scene": 4})
    run = _td_run(cfg, plans, states, hops, mesh)
    out["scene_only"] = run
    out["scene_only_block"] = _block_reference(cfg, plans, states, hops, mesh, run["rebuilt"])
    out["scene_only_mine"] = [
        {k: v[mesh.coordinate("scene") : mesh.coordinate("scene") + 1]
         for k, v in o.items() if isinstance(v, np.ndarray)} for o in run["outs"]]

    # A mic-only mesh, one scene.
    sc = payload["mic_only"]
    cfg = sc["config"]
    out["mic_only"] = _td_run(cfg, plans_from_numpy(cfg, sc["plans"], "cpu"),
                              states_from_numpy(cfg, sc["states"], "cpu"),
                              torch.from_numpy(sc["hops"]), make_mesh({"mic": 4}))

    # The tracking solver with a +40 dB step in scene 1: each rank decides
    # from its scenes; the ranks of a mic group decide alike.
    sc = payload["tracking"]
    cfg = sc["config"]
    plans = plans_from_numpy(cfg, sc["plans"], "cpu")
    states = states_from_numpy(cfg, sc["states"], "cpu")
    hops = torch.from_numpy(sc["hops"])
    mesh = make_mesh({"scene": 2, "mic": 2})
    run = _td_run(cfg, plans, states, hops, mesh)
    out["tracking"] = run
    out["tracking_block"] = _block_reference(cfg, plans, states, hops, mesh, run["rebuilt"])
    out["tracking_mine"] = [
        {k: v[mesh.coordinate("scene") : mesh.coordinate("scene") + 1]
         for k, v in o.items() if isinstance(v, np.ndarray)} for o in run["outs"]]

    # The model with a mesh, 2 hops, against the model without one.
    sc = payload["model"]
    cfg = sc["config"]
    mesh = make_mesh({"scene": 2, "mic": 2})
    sharded = MultiSceneApVast(cfg, sc["rirs"], device="cpu", mesh=mesh)
    whole = MultiSceneApVast(cfg, sc["rirs"], device="cpu")
    model = []
    for x in sc["hops"]:
        got = sharded.process_input_buffers(x[0], x[1])
        want = whole.process_input_buffers(x[0], x[1])
        model.append((_numpy(gather_blocks(got, mesh)), _numpy(want)))
    out["model"] = model
    out["model_graphed"] = sharded.graphed

    # The FD engine, mic and scene sharding together.
    sc = payload["fd"]
    cfg = sc["config"]
    plans = plans_from_numpy(cfg, sc["plans"], "cpu")
    n = sc["hops"].shape[2]
    states = stack_states([fd_state_from_numpy(cfg, {k: None if v is None else v[i]
                                                    for k, v in sc["states"].items()},
                                               "cpu") for i in range(n)])
    mesh = make_mesh({"scene": 2, "mic": 2})
    fn = sharded_multi_scene_fd_hop(cfg, mesh, forgetting=0.9)
    plan, state = shard_plan(plans, mesh), shard_fd_state(states, mesh)
    fd = []
    for x in torch.from_numpy(sc["hops"]):
        state, o = fn(plan, state, scene_block(x[0], mesh), scene_block(x[1], mesh))
        whole = gather_blocks(state, mesh)
        assert isinstance(whole, FdState)
        fd.append((_numpy(gather_blocks(o, mesh)), _numpy(whole)))
    out["fd"] = fd
    return out
