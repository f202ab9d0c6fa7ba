"""Multi-stream serving on the CPU: the scene-batched hop
(``apvast_torch/parallel/mesh.py``), ``run_multi_stream`` and
``MultiSceneApVast``, the counterparts of the JAX package's
``jax.vmap(process_hop)``.

1. ``run_multi_stream`` in float64 under the tracking solver (warmup 2,
   period 3, 2 scenes, 7 hops) against the JAX package's, from the JAX
   plans and states carried across stacked (``utils/convert.py``): within
   1e-9 of scale, as ``tests/test_torch_tracking.py`` holds one scene;
   only rounding separates the two packages. A +20 dB step in one scene
   trips the residual trigger on a hop outside the warmup and the cadence,
   and both packages rebuild every scene there.
2. float32 with every kernel flag on (the plain versions): each
   configuration's batched hop equals, for every scene, that scene's own
   ``process_hop`` from the same state, bit for bit, outputs and state.
3. Each kernel op under vmap equals the loop of single calls bit for bit,
   with a batched and an unbatched operand, and vmap falls back to no
   per-example loop (its warning is an error here).
4. One batched hop of each graphed configuration passes
   ``tests/test_torch_graph.py``'s capture guard.
5. 'newton' batched (each scene's decision a select on the device) and a
   mesh of one rank run; what the batched hop refuses: stacked states out
   of lockstep, a shared plan field that differs, a shared operand given
   per scene.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch import MultiSceneApVast, run_multi_stream
from apvast_torch.config import ApVastConfig
from apvast_torch.engine import build_plan, hop_into, init_fd_state, init_state, process_hop
from apvast_torch.engine import process_hop_fd
from apvast_torch.engine.graph import clone_state
from apvast_torch.ops import kernels as K
from apvast_torch.ops.wola import windowed_block
from apvast_torch.parallel import sharded_multi_scene_fd_hop, sharded_multi_scene_hop
from apvast_torch.parallel.mesh import make_mesh, scene_of, stack_plans, stack_states
from apvast_torch.utils.convert import config_from_jax, plans_from_numpy, states_from_numpy
from apvast_torch.utils.rir import synthetic_rirs
from apvast_tpu.config import ApVastConfig as JaxConfig
from apvast_tpu.config import GevdSolver
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine.stream import run_multi_stream as jax_run_multi_stream
from test_torch_graph import _CONFIGS, _SCENE, HostDataError, guarded
from _torch_dist import one_rank_group
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

HOPS = 7
STEP_HOP = 3  # the +20 dB step of scene 1: its residual trips the trigger for hop 4
THRESHOLD = 2.5  # the production configuration's


def _arrays(tree) -> dict:
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def float64_runs():
    """Both packages' run_multi_stream over the same 2 scenes and signals."""
    rirs = [(synthetic_rirs(64, 4, 3, seed=60 + i), synthetic_rirs(64, 4, 3, seed=65 + i))
            for i in range(2)]
    jc = JaxConfig.for_rirs(
        *rirs[0], block_size=64, filter_length=8, modeling_delay=3, reference_index_a=0,
        reference_index_b=1, num_eigenvectors=4, mu=1.0, statistics_buffer_length=96,
        sampling_rate=8000, perceptual=True, gevd_solver=GevdSolver.SUBSPACE,
        subspace_whiten="tracking", tracking_warmup_hops=2, tracking_rebuild_period=3,
        tracking_residual_rebuild=THRESHOLD)
    stack = lambda trees: jax.tree.map(lambda *x: jnp.stack(x), *trees)  # noqa: E731
    jplans = stack([jax_build_plan(jc, a, b) for a, b in rirs])
    jstates = stack([jax_init_state(jc, key=jax.random.key(i)) for i in range(2)])
    rng = np.random.default_rng(21)
    sig = rng.standard_normal((2, 2, jc.hop * HOPS))  # (a/b, scene, samples)
    sig[:, 1, : jc.hop * STEP_HOP] *= 0.1  # scene 1 steps up by 20 dB at STEP_HOP
    jfinal, jout = jax_run_multi_stream(jc, jplans, jstates, jnp.asarray(sig[0]),
                                        jnp.asarray(sig[1]))
    tc = config_from_jax(dataclasses.asdict(jc))
    plans = plans_from_numpy(tc, _arrays(jplans), "cpu")
    states = states_from_numpy(tc, _arrays(jstates), "cpu")
    final, out = run_multi_stream(tc, plans, clone_state(states), torch.from_numpy(sig[0]),
                                  torch.from_numpy(sig[1]))
    return tc, plans, states, sig, (final, out), (jfinal, jout)


def test_run_multi_stream_float64_matches_jax(float64_runs):
    _, _, _, _, (final, out), (jfinal, jout) = float64_runs
    assert out.out_a.shape[:2] == (HOPS, 2)
    for name in ("out_a", "out_b", "out_a_t", "out_b_t"):
        assert _rel(getattr(out, name), getattr(jout, name)) <= 1e-9, name
    assert _rel(final.gevd_minv, jfinal.gevd_minv) <= 1e-9
    assert final.gevd_hop == HOPS == int(jfinal.gevd_hop[0])
    assert int(out.silenced.sum()) == 0


def test_one_scene_residual_rebuilds_every_scene(float64_runs):
    """The rebuild is one decision for all scenes: scene 1's level step
    rebuilds scene 0 too on hop STEP_HOP + 1 (outside warmup and cadence),
    where scene 0's own residual would not; scene 0's batched outputs equal
    its own hop under the shared decisions, bit for bit."""
    tc, plans, states, sig, (_, out), _ = float64_runs
    rebuilt = out.rebuilt.tolist()
    # Warmup (0, 1), cadence (3, 6), the residual after the cold hops (2)
    # and after scene 1's step (4, 5).
    assert rebuilt == [True] * HOPS
    plan0, state0 = scene_of(plans, 0), scene_of(states, 0)
    h = tc.hop
    own = []
    for i in range(HOPS):
        a, b = (torch.from_numpy(sig[k, 0, i * h:(i + 1) * h]) for k in (0, 1))
        own.append(process_hop(tc, plan0, state0, a, b)[1].rebuilt)  # its own decision
        state0, out0 = process_hop(tc, plan0, state0, a, b, rebuild_override=rebuilt[i])
        for name in ("out_a", "out_b", "out_a_t", "out_b_t"):
            assert torch.equal(getattr(out0, name), getattr(out, name)[i, 0]), (i, name)
    assert own[STEP_HOP + 1:STEP_HOP + 3] == [False, False]  # scene 0 alone would not rebuild


# name -> extra overrides: hops 0 and 2 rebuild (warmup, cadence), hop 1 not.
_TRACKING = {"tracking_warmup_hops": 1, "tracking_rebuild_period": 2}
_EQUAL_CASES = ("production", "invert", "solve", "dense", "weighting-conv", "exact",
                "fd-jacobi", "fd-full")


def _scenes(name, n, **extra):
    overrides, fd, _ = _CONFIGS[name]
    rirs = [(synthetic_rirs(120, 4, 3, seed=2 * i + 1), synthetic_rirs(120, 4, 3, seed=2 * i + 2))
            for i in range(n)]
    cfg = ApVastConfig.for_rirs(*rirs[0], **(_SCENE | overrides | extra))
    plans = [build_plan(cfg, a, b, "cpu") for a, b in rirs]
    init = init_fd_state if fd else init_state
    states = [init(cfg, "cpu", generator=torch.Generator().manual_seed(i)) for i in range(n)]
    return cfg, plans, states, fd


def _assert_scene_equal(batched, single, i, where):
    for f in dataclasses.fields(single):
        got, want = getattr(batched, f.name), getattr(single, f.name)
        if isinstance(want, torch.Tensor):
            assert torch.equal(got[i] if f.name != "rebuilt" else got, want), (where, f.name)
        elif f.name != "rebuilt":
            assert got == want, (where, f.name)


@pytest.mark.parametrize("name", _EQUAL_CASES)
def test_each_scene_equals_its_own_hop(name):
    extra = _TRACKING if name in ("production", "dense", "weighting-conv") else {}
    cfg, plans, states, fd = _scenes(name, 3, **extra)
    hop = (sharded_multi_scene_fd_hop(cfg) if fd else sharded_multi_scene_hop(cfg))
    bplan, bstate = stack_plans(plans), stack_states(states)
    rng = np.random.default_rng(4)
    rebuilds = []
    for h in range(3):
        x = torch.from_numpy(rng.standard_normal((2, 3, cfg.hop)).astype(np.float32))
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # vmap's per-example fallback warns
            bstate, bout = hop(bplan, bstate, x[0], x[1])
        rebuilds.append(bout.rebuilt)
        for i in range(3):
            if fd:
                states[i], out = process_hop_fd(cfg, plans[i], states[i], x[0, i], x[1, i])
            else:
                states[i], out = process_hop(cfg, plans[i], states[i], x[0, i], x[1, i],
                                             rebuild_override=bout.rebuilt)
            _assert_scene_equal(bout, out, i, (h, i))
            _assert_scene_equal(bstate, states[i], i, (h, i))
    if extra:
        assert rebuilds == [True, False, True]


def _seeded(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.complex64:
        h = torch.randn(*shape, 2, generator=g)
        h = torch.view_as_complex(h)
        return (h + h.transpose(-1, -2).conj()).contiguous()
    return torch.randn(*shape, generator=g, dtype=dtype)


def _spd(*shape, seed=0):
    x = _seeded(*shape, seed=seed)
    return x @ x.transpose(-1, -2) / shape[-1] + torch.eye(shape[-1])


class _Scenes:
    """An operand with a leading scene axis."""

    def __init__(self, t):
        self.t = t


_N = 3
# name -> (wrapper, arguments: _Scenes operands and what all scenes share).
_OPS = {
    "streaming_conv": (K.streaming_conv, [_Scenes(_seeded(_N, 2, 64)),
                                          _Scenes(_seeded(_N, 2, 5, 20, seed=1)), 16]),
    "lag_corr": (K.lag_corr, [_Scenes(_seeded(_N, 4, 2, 3, 30)), 6]),
    "lag_skew_assemble": (K.lag_skew_assemble, [
        _Scenes(_seeded(_N, 4, 12, 6)), _Scenes(_seeded(_N, 4, 6, 12, seed=1)),
        _Scenes(_seeded(_N, 4, 3, 12, seed=2)), 4, True]),
    "jacobi_eigh": (K.jacobi_eigh, [_Scenes(_spd(_N, 2, 12, 12)), 2]),
    "circular_filter_overlap": (K.circular_filter_overlap, [
        _Scenes(_seeded(_N, 2, 32)), _Scenes(_seeded(_N, 2, 6, 8, seed=1)),
        torch.hann_window(32), _Scenes(_seeded(_N, 2, 6, 16, seed=2)), 16]),
    "covariance": (K.covariance, [_Scenes(_seeded(_N, 4, 2, 3, 24)),
                                  _Scenes(_seeded(_N, 2, 2, 20, seed=1)), 5]),
    "jacobi_eigh_hermitian": (K.jacobi_eigh_hermitian, [
        _Scenes(_seeded(_N, 5, 4, 4, dtype=torch.complex64)), 3]),
    "rowwise_circular_conv": (K.rowwise_circular_conv, [
        _Scenes(_seeded(_N, 4, 2, 3, 32)), _Scenes(_seeded(_N, 2, 2, 16, 20, seed=1)), 5, 16]),
    "subspace_iterate": (K.subspace_iterate, [
        _Scenes(_spd(_N, 2, 24, 24)),
        _Scenes(torch.linalg.inv(torch.linalg.cholesky(_spd(_N, 2, 24, 24, seed=1))).contiguous()),
        _Scenes(_seeded(_N, 2, 24, 8, seed=2)), 2, 1e-6]),
    "chol_panel": (K.chol_panel, [_Scenes(_spd(_N, 2, 128, 128))]),
    "windowed_block": (windowed_block, [torch.hann_window(32), _Scenes(_seeded(_N, 4, 3, 12)),
                                        _Scenes(_seeded(_N, 4, 3, 20, seed=1))]),
}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _slots(args):
    return [k for k, a in enumerate(args) if isinstance(a, _Scenes)]


@pytest.mark.parametrize("name,unbatched", [(n, False) for n in _OPS] + [
    (n, True) for n, (_, args) in _OPS.items() if len(_slots(args)) > 1])
def test_folded_op_equals_single_calls(name, unbatched):
    """vmap over N scenes equals N single calls bit for bit; with
    ``unbatched`` the last per-scene operand (of several) is scene 0's for
    all scenes, passed unbatched."""
    wrapper, args = _OPS[name]
    slots = _slots(args)
    fixed = {slots[-1]: args[slots[-1]].t[0]} if unbatched else {}
    vmapped = [k for k in slots if k not in fixed]

    def call(*operands):
        full = list(args)
        for k, t in zip(vmapped, operands):
            full[k] = t
        for k, t in fixed.items():
            full[k] = t
        return wrapper(*full)

    before = K.launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # vmap's per-example fallback warns
        got = _tuple(torch.func.vmap(call)(*(args[k].t for k in vmapped)))
    want = [_tuple(call(*(args[k].t[i] for k in vmapped))) for i in range(_N)]
    for j, g in enumerate(got):
        assert torch.equal(g, torch.stack([w[j] for w in want])), j
    assert K.launch_counts() == before  # a CPU tensor launches nothing


def test_ops_have_fake_shapes():
    """Every folded op is an ``apvast_torch`` op whose fake function gives
    the shapes of the wrapper's real outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for name, (wrapper, args) in _OPS.items():
        scene0 = [a.t[0] if isinstance(a, _Scenes) else a for a in args]
        real = _tuple(wrapper(*scene0))
        op = getattr(torch.ops.apvast_torch, name)
        with FakeTensorMode() as mode:
            fake = _tuple(op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                               for a in scene0)))
        assert [r.shape for r in real] == [f.shape for f in fake], name
        assert [r.dtype for r in real] == [f.dtype for f in fake], name


_GUARDED = ("production", "invert", "solve", "newton", "dense", "weighting-conv",
            "output-spans", "fft-conv-and-wola", "matmul-wola", "fd-jacobi", "fd-full",
            "fd-coupled", "fd-cg")


@pytest.mark.parametrize("name", _GUARDED)
def test_batched_hop_passes_the_guard(name, monkeypatch):
    cfg, plans, states, fd = _scenes(name, 2)
    plan, state = stack_plans(plans), stack_states(states)
    hops = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 2, 2, cfg.hop)).astype(np.float32))  # (hop, a/b, scene, samples)
    hop_into(cfg, plan, state, hops[0, 0], hops[0, 1], True, batched=True)  # the warmup
    branches = (True, False) if "gevd_resid" in dataclasses.asdict(state) else (False,)
    for i, rebuilt in enumerate(branches, start=1):
        with guarded(monkeypatch):
            hop_into(cfg, plan, state, hops[i, 0], hops[i, 1], rebuilt, batched=True)


def test_exact_batched_hop_fails_the_guard(monkeypatch):
    """The guard sees through the batched hop: the exact solver's eigh
    check is a device read."""
    cfg, plans, states, _ = _scenes("exact", 2)
    plan, state = stack_plans(plans), stack_states(states)
    x = torch.zeros(2, 2, cfg.hop)
    with pytest.raises(HostDataError), guarded(monkeypatch):
        hop_into(cfg, plan, state, x[0], x[1], batched=True)


def test_refusals(tmp_path):
    """'newton' and a mesh, refused before the batched select form and
    sharding were ported, run: a batched 'newton' hop per scene and the
    model, and a mesh of one rank (``tests/test_torch_sharding.py`` shards
    over several) equal to no mesh bit for bit. What the batched hop still
    refuses: stacked states out of lockstep, a shared plan field that
    differs, a shared operand given per scene."""
    cfg, plans, states, _ = _scenes("newton", 2)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 2, cfg.hop)).astype(np.float32))
    _, out = sharded_multi_scene_hop(cfg)(stack_plans(plans), stack_states(states), x[0], x[1])
    assert out.rebuilt.tolist() == [True, True] and torch.isfinite(out.out_a).all()
    rirs = [(synthetic_rirs(120, 4, 3, seed=1), synthetic_rirs(120, 4, 3, seed=2))] * 2
    out = MultiSceneApVast(cfg, rirs, device="cpu").process_input_buffers(x[0], x[1])
    assert torch.isfinite(out.out_a).all()
    cfg, plans, states, _ = _scenes("production", 2)
    plan, state = stack_plans(plans), stack_states(states)
    with one_rank_group(tmp_path):
        mesh = make_mesh({"scene": 1})  # K1 (use_pallas_conv) refuses a mic axis
        _, got = sharded_multi_scene_hop(cfg, mesh=mesh)(plan, clone_state(state), x[0], x[1])
        model = MultiSceneApVast(cfg, rirs, device="cpu", mesh=mesh)
        with_mesh = model.process_input_buffers(x[0], x[1])
        fd_cfg, fd_plans, fd_states, _ = _scenes("fd-jacobi", 2)
        fd_plan, fd_state = stack_plans(fd_plans), stack_states(fd_states)
        _, fd_got = sharded_multi_scene_fd_hop(fd_cfg, mesh=mesh)(fd_plan, fd_state, x[0], x[1])
    _, want = sharded_multi_scene_hop(cfg)(plan, state, x[0], x[1])
    without = MultiSceneApVast(cfg, rirs, device="cpu").process_input_buffers(x[0], x[1])
    _, fd_want = sharded_multi_scene_fd_hop(fd_cfg)(fd_plan, fd_state, x[0], x[1])
    for name in ("out_a", "out_b", "out_a_t", "out_b_t"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(with_mesh, name), getattr(without, name)), name
        assert torch.equal(getattr(fd_got, name), getattr(fd_want, name)), name
    # Stacked states out of lockstep, from the JAX package's arrays and the port's.
    arrays = {name: np.stack([v, v]) if v is not None else None
              for name, v in _arrays(states[0]).items()}
    arrays["gevd_hop"] = np.array([3, 4])
    with pytest.raises(ValueError, match="gevd_hop differs between scenes"):
        states_from_numpy(cfg, arrays, "cpu")
    states[1].gevd_hop = 1
    with pytest.raises(ValueError, match="gevd_hop differs between scenes"):
        stack_states(states)
    # A plan field that the scenes must share, differing.
    plans[1].window = plans[1].window * 2
    with pytest.raises(ValueError, match="window differs between scenes"):
        stack_plans(plans)
    # K5's window given per scene.
    call = lambda x, w: K.circular_filter_overlap(  # noqa: E731
        x, torch.zeros(2, 6, 8), w, torch.zeros(2, 6, 16), 16)
    with pytest.raises(ValueError, match="window is shared by every scene"):
        torch.func.vmap(call)(torch.zeros(2, 2, 32), torch.ones(2, 32))


def test_multi_scene_model_on_the_cpu():
    """MultiSceneApVast: (N, hop) batches in, a scene axis out, each scene
    its own eager model's hop; wrong shapes raise as in JAX; no graph on
    the CPU (graph=True raises)."""
    cfg, plans, states, _ = _scenes("production", 2)
    rirs = [(synthetic_rirs(120, 4, 3, seed=2 * i + 1), synthetic_rirs(120, 4, 3, seed=2 * i + 2))
            for i in range(2)]
    model = MultiSceneApVast(cfg, rirs, device="cpu")
    assert model.num_scenes == 2 and not model.graphed and model.graph is None
    model.check_lockstep()
    rng = np.random.default_rng(0)
    for h in range(3):
        a, b = rng.standard_normal((2, 2, cfg.hop))
        out = model.process_input_buffers(a, b)
        for i in range(2):
            states[i], want = process_hop(cfg, plans[i], states[i], torch.from_numpy(a[i]).float(),
                                          torch.from_numpy(b[i]).float())
            assert torch.equal(out.out_a[i], want.out_a), (h, i)
    assert model.rebuilds == 3 and model.silenced.tolist() == [0, 0]
    assert model.states.gevd_hop == 3
    with pytest.raises(ValueError, match="hop batches must be"):
        model.process_input_buffers(a[:1], b[:1])
    with pytest.raises(ValueError, match="graph=True: a CUDA graph needs a CUDA device"):
        MultiSceneApVast(cfg, rirs, device="cpu", graph=True)
