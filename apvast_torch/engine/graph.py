"""The hop captured once as a CUDA graph per rebuild branch and replayed:
the counterpart of the JAX package's ``jax.jit(process_hop)``
(``apvast_tpu/models/apvast.py``, ``models/apvast_fd.py``).

A time-domain production hop is about 650 kernel launches, an FD hop
about 300; enqueued one by one from Python they leave the card idle most
of the hop. :class:`GraphedHop` owns static buffers (the two input hops,
the state, the outputs), captures the hop body :func:`hop_into` once per
branch (the tracking solver's rebuild and no-rebuild hops; one graph for
every other configuration) into one memory pool, and replays it: one
launch a hop.

The body reads nothing from the device and builds no tensor from host
data, so a graph replays the hop exactly. The tracking solver's rebuild
decision stays on the host (warmup, cadence, the previous hop's residual
above ``tracking_residual_rebuild``): when the next hop needs the
residual, it is copied into pinned host memory behind the previous
replay and read after that copy's event, one read a hop at most and none
on warmup and cadence hops. Configurations
whose hop must read the device mid-hop stay eager (:func:`eager_reason`).
A capture or replay error raises; nothing falls back to the eager hop.

The scene-batched hop (``parallel/mesh.py``, N scenes in lockstep, each
kernel launched once for all of them) is captured the same way with
``batched=True``: static inputs (N, 2, hop), the batched state, one graph
per rebuild branch, and the largest residual over the scenes read behind
the replay. Batched, 'newton' decides each scene's rebuild on the device
(a select of both branches), so it is captured as one graph whose
per-scene decision is a static output. A sharded hop (a mesh) runs
eagerly: its collectives go through the host.

The hop meter (``observability.HopMeter``) times the input copy, the
residual read and the launch on the host, the captures as set-up, and
captures its timed marks into a twin of each branch graph:
``process_hop``'s section boundaries and, last, ``writeback`` after the
state and output copies. A hop replays the branch graph without marks,
and the meter's sampled hops the twin.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from apvast_torch.config import ApVastConfig, uses_subspace_solver, uses_tracking_solver
from apvast_torch.engine.fd_hop import FdState, process_hop_fd
from apvast_torch.engine.hop import HopOutputs, process_hop, rebuild_predicate
from apvast_torch.engine.plan import ApVastPlan
from apvast_torch.observability import MARKS, meter
from apvast_torch.ops import kernels as K
from apvast_torch.parallel.mesh import sharded_multi_scene_fd_hop, sharded_multi_scene_hop
from apvast_torch.utils.device import torch_dtype

_meter = meter()

_EIGH = "torch.linalg.eigh, which checks its result on the host (a device read mid-hop)"


def eager_reason(config: ApVastConfig, fd: bool = False, batched: bool = False,
                 mesh=None) -> str | None:
    """Why the hop of ``config`` (the FD engine's when ``fd``; the
    scene-batched hop when ``batched``; sharded over ``mesh``) cannot be
    captured, or None when it can: a hop that reads the device mid-hop, or
    one that communicates."""
    if mesh is not None:
        return ("a sharded hop runs eagerly: its collectives (gloo, through the host) "
                "cannot be captured in a CUDA graph")
    if fd:
        if config.fd_span == "all" and config.fd_eigh == "lapack":
            return f"fd_eigh='lapack' solves each bin with {_EIGH}"
        if config.fd_span == "full" and config.fd_group_size > 1:
            if config.fd_group_rank_tol > 0:
                return f"the group solve's rank cutoff (fd_group_rank_tol > 0) runs {_EIGH}"
            return ("the group solve (fd_group_size > 1) builds its overlap mask from host "
                    "data and its LU solve (torch.linalg.solve_ex) is not held capture-safe")
        return None
    if not uses_subspace_solver(config):
        return f"the exact solver runs {_EIGH}"
    if config.subspace_whiten == "newton" and not batched:
        return ("'newton' decides between a Newton-Schulz step and a rebuild from the "
                "carried inverse's residual, read from the device mid-hop (the "
                "scene-batched hop selects on the device instead)")
    if config.small_eigh != "jacobi":
        return f"small_eigh='{config.small_eigh}' solves the Rayleigh-Ritz matrices with {_EIGH}"
    if config.subspace_orth != "cholqr2" and config.subspace_whiten != "tracking":
        return ("subspace_orth='qr' runs torch.linalg.qr, whose cuSOLVER and MAGMA paths "
                "are not held capture-safe")
    return None


def graph_reason(config: ApVastConfig, device: torch.device, fd: bool = False,
                 batched: bool = False, mesh=None) -> str | None:
    """Why the hop of ``config`` on ``device`` cannot run as a graph (a
    device other than a card, or :func:`eager_reason`), or None."""
    if device.type != "cuda":
        return f"a CUDA graph needs a CUDA device, this model runs on {device}"
    return eager_reason(config, fd, batched, mesh)


def _tensors(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the storages of two tensors overlap in memory (a view of a
    tensor overlaps it, wherever its offset)."""
    if a.device != b.device:
        return False
    sa, sb = a.untyped_storage(), b.untyped_storage()
    a0, b0 = sa.data_ptr(), sb.data_ptr()
    return a0 < b0 + sb.nbytes() and b0 < a0 + sa.nbytes()


def copy_state_into(dst, src) -> None:
    """Write the state ``src`` into the tensors of ``dst`` in place (host
    fields by assignment). A field that is ``dst``'s own tensor (a carry
    that a hop returns unchanged, such as a tracking hop's preconditioner
    without a rebuild) is skipped; a field whose memory overlaps any of
    ``dst``'s tensors otherwise is cloned first, so that no copy reads
    memory that an earlier copy has written."""
    targets = _tensors(dst)
    staged = {}
    for f in dataclasses.fields(dst):
        new = getattr(src, f.name)
        old = getattr(dst, f.name)
        if not isinstance(old, torch.Tensor):
            setattr(dst, f.name, new)
            continue
        if new is old or (new.data_ptr() == old.data_ptr() and new.stride() == old.stride()
                          and new.shape == old.shape):
            continue
        if any(_overlaps(new, t) for t in targets.values()):
            new = new.clone()
        staged[f.name] = new
    for name, new in staged.items():
        targets[name].copy_(new)


def clone_state(state):
    """A copy of a hop state whose tensors are contiguous clones."""
    return dataclasses.replace(state, **{
        name: t.clone(memory_format=torch.contiguous_format)
        for name, t in _tensors(state).items()
    })


def capture(fn, device):
    """``fn()`` captured as a CUDA graph, after one eager call on a side
    stream that fills the per-shape caches (cuFFT and cuBLAS plans) before
    capture. Returns the graph and ``fn``'s result, whose tensors each
    replay rewrites in place."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        result = fn()
    return graph, result


def hop_into(
    config: ApVastConfig,
    plan: ApVastPlan,
    state,
    hop_a: torch.Tensor,
    hop_b: torch.Tensor,
    rebuilt: bool = False,
    forgetting: float = 0.9,
    batched: bool = False,
) -> HopOutputs:
    """The captured body: one hop of either engine from ``state``, the new
    state written back into ``state``'s tensors (:func:`copy_state_into`).

    ``rebuilt`` is the tracking solver's rebuild decision, taken by the
    caller (ignored by the other solvers); ``forgetting`` is the FD
    engine's covariance decay; ``batched``: ``plan`` and ``state`` are
    batched over scenes and the inputs are (N, hop), the scene-batched hop
    of ``parallel/mesh.py``. Returns the hop's outputs, fresh tensors."""
    fd = isinstance(state, FdState)
    if batched:
        step = (sharded_multi_scene_fd_hop(config, forgetting=forgetting) if fd
                else sharded_multi_scene_hop(config))
        new, out = step(plan, state, hop_a, hop_b, rebuild_override=rebuilt)
    elif fd:
        new, out = process_hop_fd(config, plan, state, hop_a, hop_b, forgetting=forgetting)
    else:
        new, out = process_hop(config, plan, state, hop_a, hop_b, rebuild_override=rebuilt)
    copy_state_into(state, new)
    return out


def _static_like(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else torch.empty(t.shape, dtype=t.dtype, device=t.device)


class GraphedHop:
    """One hop of ``config`` on the card, captured once per branch and
    replayed (see the module docstring).

    ``state`` is copied into the static state, which :attr:`state` holds
    from then on (its tensors change in place with every replay). Every
    branch is warmed up eagerly on a side stream before capture, on a
    scratch copy of the state, so that every per-shape cache (K2's
    workspace size, the Jacobi kernels' tables, the kernels' attributes,
    cuBLAS and cuFFT plans) is filled before capture. The kernel wrappers'
    launch counters run in Python and so count only while a graph is
    captured: each graph keeps the counts of its capture, which
    :meth:`replay` adds, and the counts of the warmup and the captures
    are taken back out. ``batched``: the scene-batched hop (module
    docstring), ``plan`` and ``state`` batched over scenes. ``marked``:
    each branch's twin graph with the timed marks
    (``observability.MARKS``) and its events, which live as long as it;
    none where the hop has no section marks, as the FD engine's."""

    def __init__(self, config: ApVastConfig, plan: ApVastPlan, state, forgetting: float = 0.9,
                 batched: bool = False):
        device = plan.window.device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the plan is on {device}")
        fd = isinstance(state, FdState)
        reason = eager_reason(config, fd, batched)
        if reason is not None:
            raise ValueError(f"this configuration's hop cannot be captured: {reason}")
        self.config, self.plan, self.forgetting = config, plan, forgetting
        self.batched = batched
        self.tracking = not fd and uses_tracking_solver(config)
        scenes = (state.input_blocks.shape[0],) if batched else ()
        self.hops = torch.zeros((*scenes, 2, config.hop), dtype=torch_dtype(config),
                                device=device)
        self.state = clone_state(state)
        self.out: HopOutputs | None = None
        self.graphs: dict[bool, torch.cuda.CUDAGraph] = {}
        self.launches: dict[bool, dict[str, int]] = {}
        self.marked: dict[bool, tuple[torch.cuda.CUDAGraph, list[torch.cuda.Event]]] = {}
        # The previous hop's residual in pinned host memory and its copy's
        # event.
        self._resid_host = torch.zeros((), dtype=torch.float32, pin_memory=True)
        self._resid_event = torch.cuda.Event()
        with _meter.setup_span("capture"):
            self._capture(device, (True, False) if self.tracking else (False,))

    def _body(self, state, rebuilt: bool) -> HopOutputs:
        return hop_into(self.config, self.plan, state, self.hops[..., 0, :],
                        self.hops[..., 1, :], rebuilt, self.forgetting, self.batched)

    def _capture(self, device, branches) -> None:
        counts = K.launch_counts()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for rebuilt in branches:
                out = self._body(clone_state(self.state), rebuilt)
        torch.cuda.current_stream(device).wait_stream(side)
        # Outputs that are tensors get static buffers: the feeds, the
        # silenced count, and 'newton''s per-scene decision when batched.
        self.out = HopOutputs(**{
            f.name: (_static_like(value) if isinstance(value, torch.Tensor) else value)
            for f in dataclasses.fields(out) for value in (getattr(out, f.name),)
        })
        pool = None
        for rebuilt in branches:
            with _meter.setup_span("capture.rebuild" if rebuilt else "capture.hop", id(self)):
                # The branch with the meter's marks, then, if it has them,
                # its twin without, which the unsampled hops replay.
                graph, marks = self._capture_branch(device, rebuilt, pool, True)
                pool = graph.pool()
                if marks:
                    self.marked[rebuilt] = (graph, marks)
                    graph, _ = self._capture_branch(device, rebuilt, pool, False)
            self.launches[rebuilt] = K.launch_counts()
            self.graphs[rebuilt] = graph
        K.reset_launch_counts()
        K.add_launch_counts(counts)

    def _capture_branch(self, device, rebuilt: bool, pool, marked: bool):
        """The branch ``rebuilt`` captured into ``pool``, its outputs copied
        into the static outputs; ``marked``: with the meter's timed marks.
        Returns the graph and the events of its marks (none where
        the hop has no marks)."""
        K.reset_launch_counts()
        hop0 = getattr(self.state, "gevd_hop", None)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool), contextlib.ExitStack() as stack:
            marks = stack.enter_context(_meter.capturing()) if marked else []
            out = self._body(self.state, rebuilt)
            for f in dataclasses.fields(out):
                if isinstance(getattr(out, f.name), torch.Tensor):
                    getattr(self.out, f.name).copy_(getattr(out, f.name))
            if marked and tuple(name for name, _ in marks) == MARKS[:-1]:
                _meter.mark("writeback")
        torch.cuda.synchronize(device)
        if hop0 is not None:
            self.state.gevd_hop = hop0
        if marks and tuple(name for name, _ in marks) != MARKS:
            raise RuntimeError(f"the hop recorded the marks {[n for n, _ in marks]}, "
                               f"not {list(MARKS)}")
        return graph, [event for _, event in marks]

    def load(self, state) -> None:
        """Copy ``state`` into the static state (what the next replay
        starts from)."""
        copy_state_into(self.state, state)

    def stage(self, hop_a, hop_b) -> None:
        """Copy the next hop's two inputs ((hop,) each, (N, hop) batched)
        into the static input buffer: one copy of the stacked pair for host
        arrays, one each for device tensors."""
        t0 = _meter.begin("stage")
        shape = self.hops.shape[:-2] + self.hops.shape[-1:]
        if isinstance(hop_a, torch.Tensor) and isinstance(hop_b, torch.Tensor):
            self.hops[..., 0, :].copy_(hop_a.reshape(shape))
            self.hops[..., 1, :].copy_(hop_b.reshape(shape))
        else:
            self.hops.copy_(torch.stack([torch.as_tensor(hop_a).reshape(shape),
                                         torch.as_tensor(hop_b).reshape(shape)], dim=-2))
        _meter.end("stage", t0)

    def _read_resid(self) -> float:
        """The previous hop's residual (batched: the largest over the
        scenes): copied into pinned memory behind its replay, read once the
        copy's event has passed."""
        t0 = _meter.begin("resid")
        resid = self.state.gevd_resid
        self._resid_host.copy_(resid.amax() if resid.dim() else resid, non_blocking=True)
        self._resid_event.record()
        self._resid_event.synchronize()
        _meter.resid_reads += 1
        value = self._resid_host.item()
        _meter.end("resid", t0)
        return value

    def decide_rebuild(self) -> bool:
        """The tracking solver's rebuild decision for the next hop (False
        for every other solver)."""
        if not self.tracking:
            return False
        return rebuild_predicate(self.config, self.state.gevd_hop, self._read_resid)

    def replay(self, rebuilt: bool) -> HopOutputs:
        """Replay the branch ``rebuilt`` on the staged inputs. Returns the
        static outputs, which the next replay overwrites (``rebuilt`` the
        branch's, or the hop's own decision where it is a tensor)."""
        branch = bool(rebuilt)
        _meter.launch(self.graphs[branch], branch, self.marked.get(branch))
        K.add_launch_counts(self.launches[branch])
        if self.tracking:
            self.state.gevd_hop += 1
        if isinstance(self.out.rebuilt, torch.Tensor):
            return self.out
        return dataclasses.replace(self.out, rebuilt=bool(rebuilt))
