"""Sharding on ``torch.distributed`` (``apvast_torch/parallel/mesh.py``) and
the scene-batched 'newton' solver, against the JAX package's mesh layer.

1. Four spawned CPU ranks in one gloo group (``tests/_torch_dist.py``) run
   every sharded scenario once (a module fixture): the time-domain hop on
   a (scene 2 x mic 2) mesh, a scene-only and a mic-only mesh, the
   tracking solver with a +40 dB step in one scene, ``MultiSceneApVast``
   with a mesh and the FD engine on a (scene x mic) mesh. Each is held in
   float64 against the port's unsharded batched hop from the same state
   (1e-9, JAX's own bar in ``tests/test_sharding.py``), and the TD run
   also against the JAX package's own ``sharded_multi_scene_hop`` on a
   (scene 2 x mic 4) mesh of conftest's 8 virtual devices, from the same
   plans and states carried across by ``utils/convert.py``. A
   scene-sharded rank is held against the unsharded batch of its own
   scenes; the ranks of a mic group decide every rebuild alike.
2. The scene-batched 'newton' hop (each scene decides between a
   Newton-Schulz step and a rebuild on the device) against each scene's
   own hop, which decides on the host, and against the JAX package's
   vmapped hop, in float64, over hops where one scene rebuilds and the
   other does not.
3. What sharding refuses: microphones that do not split over the mesh,
   the conv kernel with a mic axis (JAX's words), a mesh the process group
   does not match.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apvast_torch.engine import build_plan, eager_reason, init_state, process_hop, process_hop_fd
from apvast_torch.engine.fd_hop import init_fd_state as port_init_fd_state
from apvast_torch.models import MultiSceneApVast
from apvast_torch.parallel.mesh import (
    Mesh,
    check_mesh,
    make_mesh,
    scene_of,
    shard_scene_batch,
    sharded_multi_scene_fd_hop,
    sharded_multi_scene_hop,
    stack_states,
)
from apvast_torch.utils.convert import (
    config_from_jax,
    fd_state_from_numpy,
    plans_from_numpy,
    states_from_numpy,
)
from apvast_tpu.config import ApVastConfig as JaxConfig
from apvast_tpu.config import GevdSolver
from apvast_tpu.engine import build_plan as jax_build_plan
from apvast_tpu.engine import init_state as jax_init_state
from apvast_tpu.engine.fd_hop import init_fd_state as jax_init_fd_state
from apvast_tpu.engine.hop import process_hop as jax_process_hop
from apvast_tpu.parallel.mesh import make_mesh as jax_make_mesh
from apvast_tpu.parallel.mesh import shard_fd_state as jax_shard_fd_state
from apvast_tpu.parallel.mesh import shard_plan as jax_shard_plan
from apvast_tpu.parallel.mesh import shard_scene_batch as jax_shard_scene_batch
from apvast_tpu.parallel.mesh import sharded_multi_scene_fd_hop as jax_fd_hop
from apvast_tpu.parallel.mesh import sharded_multi_scene_hop as jax_hop
from apvast_tpu.utils.rir import synthetic_rirs
from _torch_dist import scenarios, spawn
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

RTOL, ATOL = 1e-9, 1e-11  # JAX's own float64 bar for a sharded hop


def _jax_config(**extra):
    # 8 mics, so the mic axis splits over 2 and 4 ranks (JAX's _scene_config).
    fields = dict(rir_length=64, num_srcs=4, num_mics=8, block_size=64, filter_length=8,
                  modeling_delay=3, reference_index_a=0, reference_index_b=1,
                  num_eigenvectors=4, mu=1.0, statistics_buffer_length=96,
                  sampling_rate=8000, perceptual=True)
    return JaxConfig(**(fields | extra))


def _stack(trees):
    return jax.tree.map(lambda *x: jnp.stack(x), *trees)


def _arrays(tree) -> dict:
    return {f.name: None if getattr(tree, f.name) is None else np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _scene_batch(jc, seeds, keys, fd=False):
    """JAX plans and states of one scene a seed pair, stacked, as arrays."""
    plans = [jax_build_plan(jc, synthetic_rirs(64, 4, jc.num_mics, seed=a),
                            synthetic_rirs(64, 4, jc.num_mics, seed=b)) for a, b in seeds]
    init = jax_init_fd_state if fd else jax_init_state
    states = [init(jc, key=jax.random.key(k)) for k in keys]
    return _stack(plans), _stack(states)


def _numpy(obj) -> dict:
    return {f.name: getattr(obj, f.name).numpy() if isinstance(getattr(obj, f.name), torch.Tensor)
            else getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _port_unsharded(cfg, jplans, jstates, hops, fd=False):
    """The port's unsharded batched hop over ``hops`` (H, 2, N, hop):
    (outputs, state) of every hop as arrays."""
    plans = plans_from_numpy(cfg, _arrays(jplans), "cpu")
    if fd:
        arrays = _arrays(jstates)
        states = stack_states([
            fd_state_from_numpy(cfg, {k: None if v is None else v[i] for k, v in arrays.items()},
                                "cpu") for i in range(hops.shape[2])])
        fn = sharded_multi_scene_fd_hop(cfg, forgetting=0.9)
    else:
        states = states_from_numpy(cfg, _arrays(jstates), "cpu")
        fn = sharded_multi_scene_hop(cfg)
    runs = []
    for x in torch.from_numpy(hops):
        states, out = fn(plans, states, x[0], x[1])
        runs.append((_numpy(out), _numpy(states)))
    return runs


def _close(got, want, rtol=RTOL, atol=ATOL, where=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, where
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(np.abs(want).max(), 1.0),
                               err_msg=str(where))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every sharded scenario on 4 spawned ranks, with the references."""
    rng = np.random.default_rng(5)
    payload, refs = {}, {}

    jc = _jax_config()
    cfg = config_from_jax(dataclasses.asdict(jc))
    jplans, jstates = _scene_batch(jc, [(30, 40), (31, 41)], [0, 1])
    hops = rng.standard_normal((3, 2, 2, jc.hop))  # (hop, a/b, scene, samples)
    payload["td"] = dict(config=cfg, plans=_arrays(jplans), states=_arrays(jstates), hops=hops)
    refs["td"] = _port_unsharded(cfg, jplans, jstates, hops)
    mesh = jax_make_mesh({"scene": 2, "mic": 4})
    fn = jax_hop(jc, mesh)
    sp, ss = jax_shard_plan(jplans, mesh), jax_shard_scene_batch(jstates, mesh)
    jax_runs = []
    for x in hops:
        ss, out = fn(sp, ss, jnp.asarray(x[0]), jnp.asarray(x[1]))
        jax_runs.append((_arrays(out), _arrays(ss)))
    refs["td_jax"] = jax_runs

    jplans4, jstates4 = _scene_batch(jc, [(50 + i, 55 + i) for i in range(4)], range(4))
    hops4 = rng.standard_normal((2, 2, 4, jc.hop))
    payload["scene_only"] = dict(config=cfg, plans=_arrays(jplans4), states=_arrays(jstates4),
                                 hops=hops4)
    refs["scene_only"] = _port_unsharded(cfg, jplans4, jstates4, hops4)

    jplan1, jstate1 = _scene_batch(jc, [(90, 91)], [9])
    hops1 = np.random.default_rng(17).standard_normal((1, 2, 1, jc.hop))
    payload["mic_only"] = dict(config=cfg, plans=_arrays(jplan1), states=_arrays(jstate1),
                               hops=hops1)
    refs["mic_only"] = _port_unsharded(cfg, jplan1, jstate1, hops1)
    mesh = jax_make_mesh({"mic": 8})
    _, out = jax_hop(jc, mesh)(jax_shard_plan(jplan1, mesh), jax_shard_scene_batch(jstate1, mesh),
                               jnp.asarray(hops1[0, 0]), jnp.asarray(hops1[0, 1]))
    refs["mic_only_jax"] = _arrays(out)

    jt = _jax_config(gevd_solver=GevdSolver.SUBSPACE, subspace_whiten="tracking",
                     tracking_warmup_hops=2, tracking_rebuild_period=8,
                     tracking_residual_rebuild=2.5)
    ct = config_from_jax(dataclasses.asdict(jt))
    jplanst, jstatest = _scene_batch(jt, [(60, 65), (61, 66)], [0, 1])
    hopst = np.random.default_rng(21).standard_normal((8, 2, 2, jt.hop))
    hopst[:4, :, 1] *= 0.01  # +40 dB in scene 1 from hop 5 on
    payload["tracking"] = dict(config=ct, plans=_arrays(jplanst), states=_arrays(jstatest),
                               hops=hopst)

    pairs = [(synthetic_rirs(64, 4, 8, seed=70 + i), synthetic_rirs(64, 4, 8, seed=80 + i))
             for i in range(2)]
    payload["model"] = dict(config=cfg, rirs=pairs,
                            hops=np.random.default_rng(12).standard_normal((2, 2, 2, jc.hop)))

    jplansf, jstatesf = _scene_batch(jc, [(130, 140), (131, 141)], [0, 1], fd=True)
    hopsf = np.random.default_rng(15).standard_normal((2, 2, 2, jc.hop))
    payload["fd"] = dict(config=cfg, plans=_arrays(jplansf), states=_arrays(jstatesf),
                         hops=hopsf)
    refs["fd"] = _port_unsharded(cfg, jplansf, jstatesf, hopsf, fd=True)
    mesh = jax_make_mesh({"scene": 2, "mic": 4})
    fn = jax_fd_hop(jc, mesh)
    sp, ss = jax_shard_plan(jplansf, mesh), jax_shard_fd_state(jstatesf, mesh)
    jax_fd = []
    for x in hopsf:
        ss, out = fn(sp, ss, jnp.asarray(x[0]), jnp.asarray(x[1]))
        jax_fd.append((_arrays(out), _arrays(ss)))
    refs["fd_jax"] = jax_fd

    ranks = spawn(scenarios, 4, tmp_path_factory.mktemp("ranks"), payload)
    return ranks, refs


_OUTS = ("out_a", "out_b", "out_a_t", "out_b_t")


def test_mic_sharded_matches_unsharded(sharded):
    ranks, refs = sharded
    got, want = ranks[0]["td"], refs["td"][0]
    _close(got["outs"][0]["out_a"], want[0]["out_a"])
    _close(got["states"][0]["wresp_stat"], want[1]["wresp_stat"])


def test_mic_sharding_survives_multiple_hops(sharded):
    ranks, refs = sharded
    got = ranks[0]["td"]
    for h, (want_out, want_state) in enumerate(refs["td"]):
        for name in _OUTS + ("silenced",):
            _close(got["outs"][h][name], want_out[name], where=(h, name))
        for name, want in want_state.items():
            if isinstance(want, np.ndarray):
                _close(got["states"][h][name], want, where=(h, name))
        assert np.isfinite(got["outs"][h]["out_a"]).all()


def test_mic_sharded_matches_jax_sharded(sharded):
    """The port's gathered (scene 2 x mic 2) hops against the JAX package's
    ``sharded_multi_scene_hop`` on (scene 2 x mic 4) virtual devices."""
    ranks, refs = sharded
    got = ranks[0]["td"]
    for h, (want_out, want_state) in enumerate(refs["td_jax"]):
        for name in _OUTS:
            _close(got["outs"][h][name], want_out[name], where=(h, name))
        for name in ("wresp_stat", "wtarget_stat", "out_overlap", "resp"):
            _close(got["states"][h][name], want_state[name], where=(h, name))


def test_every_rank_gathers_the_same(sharded):
    ranks, _ = sharded
    for r in ranks[1:]:
        for h in range(3):
            for name in _OUTS:
                np.testing.assert_array_equal(r["td"]["outs"][h][name],
                                              ranks[0]["td"]["outs"][h][name])


def test_scene_only_mesh(sharded):
    """One scene a rank: each rank equals the unsharded batch of its own
    scene bit for bit, and the gathered batch the whole unsharded batch."""
    ranks, refs = sharded
    for r in ranks:
        for mine, block in zip(r["scene_only_mine"], r["scene_only_block"]):
            for name in _OUTS:
                np.testing.assert_array_equal(mine[name], block[name])
    got = ranks[0]["scene_only"]
    assert got["outs"][0]["out_a"].shape == (4, 4, 32, 4)
    for h, (want_out, _) in enumerate(refs["scene_only"]):
        for name in _OUTS:
            _close(got["outs"][h][name], want_out[name], where=(h, name))


def test_mic_only_mesh(sharded):
    """One scene, its 8 microphones over 4 ranks, against the unsharded hop
    and the JAX package's 8-device mic mesh."""
    ranks, refs = sharded
    got = ranks[0]["mic_only"]["outs"][0]
    for name in _OUTS:
        _close(got[name], refs["mic_only"][0][0][name], where=name)
        _close(got[name], refs["mic_only_jax"][name], where=name)


def test_multi_scene_wrapper(sharded):
    """``MultiSceneApVast`` with a (scene 2 x mic 2) mesh against the model
    without one; a sharded hop is never captured."""
    ranks, _ = sharded
    cfg = config_from_jax(dataclasses.asdict(_jax_config()))
    assert "sharded hop runs eagerly" in eager_reason(cfg, batched=True,
                                                      mesh=Mesh({"scene": 2}, None))
    for r in ranks:
        assert not r["model_graphed"]
        for h, (got, want) in enumerate(r["model"]):
            assert got["out_a"].shape == (2, 4, 32, 4)
            assert np.isfinite(got["out_a"]).all()
            for name in _OUTS:
                _close(got[name], want[name], where=(h, name))


def test_fd_mic_sharded_matches_unsharded(sharded):
    """FD engine on (scene 2 x mic 2) ranks against the port's unsharded FD
    hop and the JAX package's FD hop on (scene 2 x mic 4) devices."""
    ranks, refs = sharded
    for h, (got_out, got_state) in enumerate(ranks[0]["fd"]):
        for ref in (refs["fd"], refs["fd_jax"]):
            want_out, want_state = ref[h]
            for name in _OUTS:
                _close(got_out[name], want_out[name], rtol=1e-8, atol=1e-10, where=(h, name))
            for name in ("cov", "cross", "resp", "spec_hist"):
                if want_state[name] is not None:
                    _close(got_state[name], want_state[name], rtol=1e-8, atol=1e-10,
                           where=(h, name))


def test_mic_group_ranks_agree_on_rebuilt(sharded):
    """The tracking solver with a +40 dB step in scene 1: the two ranks of
    each mic group (one scene each) take the same decision every hop, the
    two groups part on some hop (each rank decides from its own scenes),
    and every rank equals the unsharded batch of its own scene driven by
    those decisions."""
    ranks, _ = sharded
    by_scene = {}
    for r in ranks:
        by_scene.setdefault(r["coords"]["scene"], []).append(r["tracking"]["rebuilt"])
    for decisions in by_scene.values():
        assert decisions[0] == decisions[1]
    assert by_scene[0][0] != by_scene[1][0]
    for r in ranks:
        for h, (mine, block) in enumerate(zip(r["tracking_mine"], r["tracking_block"])):
            for name in _OUTS:
                _close(mine[name], block[name], where=(h, name))


def test_refusals(tmp_path):
    """Microphones that do not split over the mesh, the conv kernel with a
    mic axis (the JAX package's words), and a mesh without a process group
    or of another size raise ValueError."""
    jc = _jax_config(num_mics=6)
    cfg = config_from_jax(dataclasses.asdict(jc))
    with pytest.raises(ValueError, match="does not split"):
        check_mesh(cfg, Mesh({"scene": 1, "mic": 4}, None))
    check_mesh(cfg, Mesh({"scene": 2, "mic": 3}, None))
    state = stack_states([init_state(cfg, "cpu")] * 2)
    with pytest.raises(ValueError, match="do not split"):
        shard_scene_batch(state, Mesh({"scene": 3}, None))
    with pytest.raises(ValueError, match="initialized default process group"):
        make_mesh({"scene": 2})

    rir_a, rir_b = synthetic_rirs(64, 4, 6, seed=1), synthetic_rirs(64, 4, 6, seed=2)
    jconv = dataclasses.replace(jc, use_pallas_conv=True, dtype="float32")
    hop = np.zeros(jc.hop, np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_process_hop(jconv, jax_build_plan(jconv, rir_a, rir_b), jax_init_state(jconv),
                        jnp.asarray(hop), jnp.asarray(hop), mic_axis="mic")
    tconv = config_from_jax(dataclasses.asdict(jconv))
    with pytest.raises(ValueError) as torch_err:
        process_hop(tconv, build_plan(tconv, rir_a, rir_b, "cpu"), init_state(tconv, "cpu"),
                    torch.from_numpy(hop), torch.from_numpy(hop), mic_axis=object())
    assert str(torch_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as fd_err:
        process_hop_fd(tconv, build_plan(tconv, rir_a, rir_b, "cpu"),
                       port_init_fd_state(tconv, "cpu"), torch.from_numpy(hop),
                       torch.from_numpy(hop), mic_axis=object())
    assert str(fd_err.value) == str(jax_err.value)


# ---- the scene-batched 'newton' solver ----------------------------------

NEWTON_HOPS = 12
STEP = 9  # scene 1 steps up +20 dB from this hop on: its inverse goes stale


def _newton_setup():
    """Two scenes of 'newton' driven by one hop of noise repeated (a
    periodic input: once the buffers are full the dark matrices stop
    changing, and the Newton-Schulz refresh takes over from the rebuilds)."""
    jc = _jax_config(num_mics=3, gevd_solver=GevdSolver.SUBSPACE, subspace_whiten="newton",
                     subspace_oversample=4)
    cfg = config_from_jax(dataclasses.asdict(jc))
    jplans, jstates = _scene_batch(jc, [(20, 21), (22, 23)], [0, 1])
    base = np.random.default_rng(31).standard_normal((2, 2, jc.hop))
    hops = np.repeat(base[None], NEWTON_HOPS, axis=0)
    hops[STEP:, :, 1] *= 10.0
    return jc, cfg, jplans, jstates, hops


def test_batched_newton_each_scene_matches_its_own_hop():
    """Each scene of the batched hop against its own single-scene hop from
    the same state, which decides on the host: the same decision (per
    scene, as a bool tensor), the same outputs and carries; the step
    rebuilds scene 1 alone."""
    _, cfg, jplans, jstates, hops = _newton_setup()
    plans = plans_from_numpy(cfg, _arrays(jplans), "cpu")
    states = states_from_numpy(cfg, _arrays(jstates), "cpu")
    singles = [scene_of(states, i) for i in range(2)]
    fn = sharded_multi_scene_hop(cfg)
    decisions = []
    for h, x in enumerate(torch.from_numpy(hops)):
        states, out = fn(plans, states, x[0], x[1])
        assert out.rebuilt.dtype == torch.bool and out.rebuilt.shape == (2,)
        decisions.append(out.rebuilt.tolist())
        for i in range(2):
            singles[i], ref = process_hop(cfg, scene_of(plans, i), singles[i], x[0, i], x[1, i])
            assert bool(out.rebuilt[i]) == ref.rebuilt, (h, i)
            for name in _OUTS:
                _close(getattr(out, name)[i], getattr(ref, name), rtol=1e-12, atol=1e-13,
                       where=(h, i, name))
            for name in ("gevd_q", "gevd_minv"):
                _close(getattr(states, name)[i], getattr(singles[i], name), rtol=1e-12,
                       atol=1e-13, where=(h, i, name))
    assert decisions[0] == [True, True]  # the cold start
    assert [False, False] in decisions[:STEP]  # both refreshed
    assert [False, True] in decisions[STEP:] and not any(d[0] for d in decisions[STEP:])


def test_batched_newton_matches_jax():
    """The batched 'newton' hop against the JAX package's vmapped hop
    (``sharded_multi_scene_hop(cfg)``), float64, from the same plans and
    states, over hops where one scene rebuilds and the other does not."""
    jc, cfg, jplans, jstates, hops = _newton_setup()
    plans = plans_from_numpy(cfg, _arrays(jplans), "cpu")
    states = states_from_numpy(cfg, _arrays(jstates), "cpu")
    fn, jfn = sharded_multi_scene_hop(cfg), jax_hop(jc)
    mixed = False
    for h, x in enumerate(hops):
        states, out = fn(plans, states, torch.from_numpy(x[0]), torch.from_numpy(x[1]))
        jstates, jout = jfn(jplans, jstates, jnp.asarray(x[0]), jnp.asarray(x[1]))
        mixed |= bool(out.rebuilt.any() and not out.rebuilt.all())
        for name in _OUTS:
            _close(getattr(out, name), np.asarray(getattr(jout, name)), where=(h, name))
        _close(states.gevd_minv, np.asarray(jstates.gevd_minv), where=(h, "gevd_minv"))
    assert mixed


def test_batched_newton_model_on_the_cpu():
    """``MultiSceneApVast`` runs 'newton' (refused before the batched select
    form) and counts each scene's rebuilds."""
    _, cfg, _, _, hops = _newton_setup()
    pairs = [(synthetic_rirs(64, 4, 3, seed=20 + 2 * i), synthetic_rirs(64, 4, 3, seed=21 + 2 * i))
             for i in range(2)]  # the seeds of _newton_setup's scenes
    model = MultiSceneApVast(cfg, pairs, device="cpu")
    for x in hops:
        out = model.process_input_buffers(x[0], x[1])
        assert torch.isfinite(out.out_a).all()
    assert model.rebuilds.shape == (2,) and int(model.rebuilds[1]) > int(model.rebuilds[0]) >= 1
