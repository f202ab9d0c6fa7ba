"""The graphed hop's body on the CPU (``apvast_torch/engine/graph.py``).

1. A capture-safety guard: a ``TorchDispatchMode`` that fails on any op
   that would copy host data to the card inside a captured hop (a tensor
   built from a Python list, scalar or NumPy array, lifted by
   ``aten.lift_fresh``, used as anything but the value of an in-place
   fill) or read the card from the host (``.item()``, ``bool()``, a
   result check such as ``torch.linalg.eigh``'s, a data-dependent
   shape). It catches each kind of site the port's hop had before the
   graph (list indices, per-hop gate tensors, a scalar tensor in the small
   Cholesky, the residual read), passes the safe forms that replaced them,
   passes one hop of every configuration that ``eager_reason`` graphs and
   fails every one that it keeps eager. The hop runs once before the
   guard, as a graph's warmup does, so that caches of device constants
   are filled; the kernels' plain versions stand in for the kernels on
   the CPU and run outside the guard.
2. ``hop_into`` (the captured body, which writes the new state into the
   old state's tensors) against ``process_hop`` over 12 hops, bit for bit:
   production with forced (warmup, cadence) and residual-triggered
   rebuilds, 'invert' with K9 and K10a, and fd-jacobi. The rebuild
   sequence is the eager run's, and the copy-back never corrupts a carried
   field (a preconditioner returned unchanged, fields that alias each
   other or a view of the state at an offset).
3. The models' ``graph`` argument on the CPU (no graph: eager by default,
   ValueError for ``graph=True``) and the launch counters' replay adder.
"""

import contextlib
import dataclasses
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

from apvast_torch import production_overrides
from apvast_torch.config import ApVastConfig, GevdSolver, uses_tracking_solver
from apvast_torch.engine import (
    build_plan,
    eager_reason,
    hop_into,
    init_fd_state,
    init_state,
    process_hop,
    process_hop_fd,
)
from apvast_torch.engine.graph import clone_state, copy_state_into
from apvast_torch.engine.hop import rebuild_predicate
from apvast_torch.ops import kernels as K
from apvast_torch.utils.rir import synthetic_rirs
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

aten = torch.ops.aten


class HostDataError(AssertionError):
    pass


# Ops that read the card from the host, or whose result the host checks
# (torch.linalg.eigh raises on a failed solve, so it synchronizes).
_READS = {aten._local_scalar_dense.default, aten.is_nonzero.default, aten.equal.default,
          aten.nonzero.default, aten.masked_select.default, aten._linalg_eigh.default}
_LIFTS = {aten.lift_fresh.default, aten.lift_fresh_copy.default}


class CaptureGuard(TorchDispatchMode):
    """Fails on an op that a captured hop cannot replay (module docstring)."""

    def __init__(self):
        super().__init__()
        self.lifted: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _READS:
            raise HostDataError(f"{func} reads the device from the host")
        leaves = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if func is aten.index.Tensor and any(t.dtype == torch.bool for t in leaves[1:]):
            raise HostDataError("boolean-mask indexing has a data-dependent shape")
        fill = func is aten.fill_.Tensor
        if any(id(t) in self.lifted for t in (leaves[:1] if fill else leaves)):
            raise HostDataError(f"{func} takes a tensor built from host data")
        out = func(*args, **kwargs)
        if func in _LIFTS:
            self.lifted.add(id(out))
        return out


_KERNEL_MODULES = ("jacobi_eigh", "jacobi_eigh_hermitian", "lag_corr", "output_filter",
                   "rowwise_conv", "skew_assembly", "statistics", "streaming_conv",
                   "subspace", "whiten")


def _outside_guard(fn):
    def plain(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return plain


@contextlib.contextmanager
def guarded(monkeypatch):
    """The guard around a hop, the kernels' plain versions outside it."""
    for name in _KERNEL_MODULES:
        module = importlib.import_module(f"apvast_torch.ops.kernels.{name}")
        for attr in dir(module):
            if attr.endswith("_plain") or attr == "blocked_chol_inverse":
                monkeypatch.setattr(module, attr, _outside_guard(getattr(module, attr)))
    with CaptureGuard():
        yield


def _x():
    return torch.arange(24, dtype=torch.float32).reshape(4, 6) + 1


# The kinds of site the hop had before the graph, and the forms that replaced them.
_UNSAFE = {
    "gate-from-list": lambda x: x * torch.tensor([1.0, 1.0, 0.0, 0.0])[:, None],
    "list-index": lambda x: x[[0, 3]],
    "scalar-tensor-floor": lambda x: torch.maximum(x, torch.tensor(1e-30)),
    "numpy-mask": lambda x: torch.where(torch.as_tensor(np.array([True, False] * 3)), x, 0.0),
    "residual-read": lambda x: bool(x.sum() > 2.5),
    "item": lambda x: x[0, 0].item(),
    "eigh": lambda x: torch.linalg.eigh(x[:, :4] @ x[:, :4].T),
    "bool-mask-index": lambda x: x[x > 3.0],
}
_SAFE = {
    "slice-0::3": lambda x: x[0::3].contiguous(),
    "slice-1:3": lambda x: x[1:3].contiguous(),
    "clamp-min": lambda x: x.clamp_min(1e-30),
    "scalar-fill": lambda x: x.clone().__setitem__(0, 1.0),
    "where-scalar": lambda x: torch.where(x > 3.0, x, 0.0),
    "factories": lambda x: torch.eye(4) + torch.zeros(4) + torch.arange(4),
    "cholesky-ex": lambda x: torch.linalg.cholesky_ex(x[:, :4] @ x[:, :4].T + torch.eye(4)),
}


@pytest.mark.parametrize("name", list(_UNSAFE))
def test_guard_catches_host_data(name):
    x = _x()
    with pytest.raises(HostDataError), CaptureGuard():
        _UNSAFE[name](x)


@pytest.mark.parametrize("name", list(_SAFE))
def test_guard_passes_safe_forms(name):
    x = _x()
    with CaptureGuard():
        _SAFE[name](x)


_SCENE = dict(block_size=128, filter_length=16, modeling_delay=5, reference_index_a=1,
              reference_index_b=2, num_eigenvectors=6, mu=1.0, statistics_buffer_length=160,
              sampling_rate=8000, perceptual=True)
_INVERT = {"subspace_whiten": "invert", "jacobi_sweeps": 3, "subspace_oversample": 10,
           "use_pallas_subspace": True, "use_pallas_whiten": True}
_FD = {"use_matmul_dft": True, "use_pallas_conv": True, "dtype": "float32",
       "statistics_buffer_length": 33, "num_eigenvectors": 4}
# name -> (config overrides, FD engine, graphed by eager_reason).
_CONFIGS = {
    "production": (production_overrides(), False, True),
    "invert": (production_overrides() | _INVERT, False, True),
    "solve": (production_overrides() | {"subspace_whiten": "solve"}, False, True),
    "dense": (production_overrides() | {"use_lag_statistics": False}, False, True),
    "weighting-conv": (production_overrides() | {"weighting_conv_taps": 31}, False, True),
    "output-spans": (production_overrides() | {"output_spans": (1, 3)}, False, True),
    "fft-conv-and-wola": (production_overrides() | {"use_pallas_conv": False,
                                                    "use_matmul_dft": False}, False, True),
    "matmul-wola": (production_overrides() | {"use_matmul_dft": True}, False, True),
    "exact": (production_overrides() | {"gevd_solver": GevdSolver.EIGH}, False, False),
    "newton": (production_overrides() | {"subspace_whiten": "newton"}, False, False),
    "pair-assembly": (production_overrides() | {"lag_assembly": "pair"}, False, True),
    "wide-assembly": (production_overrides() | {"lag_assembly": "wide"}, False, True),
    "tap-assembly": (production_overrides() | {"lag_assembly": "tap"}, False, True),
    "fd-jacobi": (_FD | {"fd_eigh": "jacobi"}, True, True),
    "fd-full": (_FD | {"fd_span": "full"}, True, True),
    "fd-coupled": (_FD | {"fd_span": "full", "fd_bin_coupling": 7, "fd_frame_taps": 2,
                          "num_eigenvectors": 8}, True, True),
    "fd-cg": (_FD | {"fd_span": "full", "fd_coupled_iters": 2}, True, True),
    "fd-lapack": (_FD, True, False),
}


def _setup(name, **extra):
    overrides, fd, _ = _CONFIGS[name]
    rir_a, rir_b = synthetic_rirs(120, 4, 3, seed=1), synthetic_rirs(120, 4, 3, seed=2)
    cfg = ApVastConfig.for_rirs(rir_a, rir_b, **(_SCENE | overrides | extra))
    plan = build_plan(cfg, rir_a, rir_b, "cpu")
    gen = torch.Generator().manual_seed(0)
    state = (init_fd_state(cfg, "cpu", generator=gen) if fd
             else init_state(cfg, "cpu", generator=gen))
    return cfg, plan, state, fd


def _hops(cfg, n, seed=4, step_at=None):
    rng = np.random.default_rng(seed)
    hops = rng.standard_normal((n, 2, cfg.hop)).astype(np.float32)
    if step_at is not None:  # a +20 dB level step
        hops[:step_at] *= 0.1
    return torch.from_numpy(hops)


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_graphed_configurations_pass_the_guard(name, monkeypatch):
    cfg, plan, state, fd = _setup(name)
    graphed = _CONFIGS[name][2]
    assert (eager_reason(cfg, fd) is None) == graphed
    hops = _hops(cfg, 3)
    branches = (True, False) if name in ("production", "dense", "weighting-conv",
                                         "output-spans", "fft-conv-and-wola", "matmul-wola",
                                         "pair-assembly", "wide-assembly",
                                         "tap-assembly") else (False,)
    hop_into(cfg, plan, state, hops[0, 0], hops[0, 1], True)  # the warmup fills the caches
    for i, rebuilt in enumerate(branches, start=1):
        if graphed:
            with guarded(monkeypatch):
                hop_into(cfg, plan, state, hops[i, 0], hops[i, 1], rebuilt)
        else:
            with pytest.raises(HostDataError), guarded(monkeypatch):
                hop_into(cfg, plan, state, hops[i, 0], hops[i, 1], rebuilt)


def _assert_state_equal(got, want, hop):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), (hop, f.name)
        else:
            assert g == w, (hop, f.name)


_BODY_CASES = {
    "production": ("production", dict(tracking_warmup_hops=2, tracking_rebuild_period=5,
                                      tracking_residual_rebuild=0.35), 6),
    "invert": ("invert", {}, None),
    "fd-jacobi": ("fd-jacobi", {}, None),
}


@pytest.mark.parametrize("case", list(_BODY_CASES))
def test_hop_into_equals_process_hop(case):
    name, extra, step_at = _BODY_CASES[case]
    cfg, plan, state, fd = _setup(name, **extra)
    body = clone_state(state)
    hops = _hops(cfg, 12, step_at=step_at)
    eager_rebuilds, body_rebuilds = [], []
    for i in range(12):
        a, b = hops[i]
        if fd:
            state, want = process_hop_fd(cfg, plan, state, a, b, forgetting=0.9)
            got = hop_into(cfg, plan, body, a, b, forgetting=0.9)
        else:
            state, want = process_hop(cfg, plan, state, a, b)
            rebuilt = uses_tracking_solver(cfg) and rebuild_predicate(
                cfg, body.gevd_hop, lambda: body.gevd_resid.item())
            carried = body.gevd_minv.clone() if body.gevd_minv is not None else None
            got = hop_into(cfg, plan, body, a, b, rebuilt)
            if carried is not None and not rebuilt:
                assert torch.equal(body.gevd_minv, carried), i  # the carry, unchanged
            eager_rebuilds.append(want.rebuilt)
            body_rebuilds.append(rebuilt)
        for f in ("out_a", "out_b", "out_a_t", "out_b_t", "silenced"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (i, f)
        _assert_state_equal(body, state, i)
    assert body_rebuilds == eager_rebuilds
    if case == "production":
        # Warmup (hops 0, 1), the cadence (5, 10) and the level step's
        # residual trigger on a hop outside both.
        assert body_rebuilds[:2] == [True, True] and body_rebuilds[5] and body_rebuilds[10]
        assert any(r for i, r in enumerate(body_rebuilds) if i >= 2 and i % 5)


@dataclasses.dataclass
class _Pairs:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    n: int


def test_copy_back_handles_aliasing():
    """Fields that alias each other (a swap) and a view of the state's own
    storage at an offset are copied as values: each is cloned first."""
    base = torch.arange(14.0).reshape(2, 7)
    dst = _Pairs(x=torch.arange(6.0), y=-torch.arange(6.0), z=base[:, :6], n=3)
    want = _Pairs(x=dst.y.clone(), y=dst.x.clone(), z=base[:, 1:].clone(), n=4)
    copy_state_into(dst, _Pairs(x=dst.y, y=dst.x, z=base[:, 1:], n=4))
    for f in ("x", "y", "z"):
        assert torch.equal(getattr(dst, f), getattr(want, f)), f
    assert dst.n == 4
    keep = dst.x
    copy_state_into(dst, dataclasses.replace(dst, n=5))  # every field its own: no copy
    assert dst.x is keep and dst.n == 5


def test_launch_counts_add():
    before = K.launch_counts()
    try:
        K.reset_launch_counts()
        K.add_launch_counts({"jacobi_eigh": 2, "lag_corr": 1})
        K.add_launch_counts({"jacobi_eigh": 1})
        counts = K.launch_counts()
        assert counts["jacobi_eigh"] == 3 and counts["lag_corr"] == 1
        assert sum(counts.values()) == 4
    finally:
        K.reset_launch_counts()
        K.add_launch_counts(before)


def test_graph_argument_on_the_cpu():
    """No graph on the CPU: graph=None runs eagerly and says why, graph=True
    raises naming the reason."""
    from apvast_torch import ApVast, ApVastFD

    rir_a, rir_b = synthetic_rirs(120, 4, 3, seed=1), synthetic_rirs(120, 4, 3, seed=2)
    scene = {k: v for k, v in _SCENE.items() if k != "num_eigenvectors"}
    model = ApVast(rir_a=rir_a, rir_b=rir_b, number_of_eigenvectors=6, device="cpu",
                   **scene, **production_overrides())
    assert not model.graphed and model.graph is None and "CUDA" in model.eager_reason
    for build, extra in ((ApVast, {"statistics_buffer_length": 160}), (ApVastFD, {})):
        kwargs = {k: v for k, v in scene.items() if k != "statistics_buffer_length"} | extra
        with pytest.raises(ValueError, match="graph=True: a CUDA graph needs a CUDA device"):
            build(rir_a=rir_a, rir_b=rir_b, number_of_eigenvectors=4, device="cpu",
                  graph=True, dtype="float32", **kwargs)
