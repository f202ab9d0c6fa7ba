"""The tracking solver's Rayleigh-Ritz kernel (``ops/kernels/tracked_rr.py``,
``csrc/tracked_rr.cu``): its plain version against the chain
``jdiag_topk_tracked`` ran step by step, bit for bit; the wrappers and
their ops under ``torch.func.vmap`` on the CPU; the solver's dispatch rule
(on fake CUDA tensors); and, on the card (marker ``cuda``), the kernel
against a float64 evaluation of the chain, its failure semantics through
the solver, its repeatability and its launches in the production graph.

Tolerances on the card: h, y and libar within twice the plain float32
chain's own distance from the float64 chain, per output (the kernel's
Cholesky and inverses take chol_warp.cuh's order, as K9's and K10a's do);
the coordinates within 1e-4 of their plain version (float32 sums in
another order).
"""

import importlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from apvast_torch.ops import kernels as K
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

# ``apvast_torch.ops`` exports a function named ``jdiag``: the module by its
# full name.
J = importlib.import_module("apvast_torch.ops.jdiag")
TOL_ORACLE_RATIO = 2.0


def _raw_projections(seed, z, k, dtype=torch.float64, device="cpu"):
    """s^T A s and s^T B s of a random (z, 3k, 2k) basis s and SPD A, B:
    the tracker's raw projections (not exactly symmetric in rounding), one
    scale a zone."""
    rng = np.random.default_rng(seed)
    n = 3 * k
    x = rng.standard_normal((z, n, n))
    y = rng.standard_normal((z, n, n))
    s = rng.standard_normal((z, n, 2 * k))
    scale = np.logspace(-1, 1, z)[:, None, None]
    a = scale * (x @ np.swapaxes(x, 1, 2)) / n
    b = scale * (y @ np.swapaxes(y, 1, 2) / n + np.eye(n))
    st = np.swapaxes(s, 1, 2)
    t = lambda m: torch.from_numpy(np.ascontiguousarray(m)).to(dtype).to(device)  # noqa: E731
    return t(st @ a @ s), t(st @ b @ s)


def _chain(abar, bbar, k):
    """The chain of ``jdiag_topk_tracked`` before the kernel, step by step
    with the solver module's own functions."""
    abar, bbar = J._sym(abar), J._sym(bbar)
    kk = bbar.shape[-1]
    eyek = torch.eye(kk, dtype=bbar.dtype)
    tr = torch.diagonal(bbar, dim1=-2, dim2=-1).sum(-1) / kk
    bbar = bbar + (8.0 * torch.finfo(bbar.dtype).eps * tr)[:, None, None] * eyek
    lbar = J.cholesky(bbar)
    libar = J.triangular_inverse(lbar)
    wbar = J._sym((libar @ abar) @ libar.transpose(-1, -2))
    y = J._cholqr2(lbar.transpose(-1, -2)[:, :, :k])
    for _ in range(2):
        y = J._cholqr2(wbar @ y)
    return J._sym(y.transpose(-1, -2) @ (wbar @ y)), y, libar


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("z", [2, 16])
def test_plain_version_is_the_chain_bit_for_bit(z, k, dtype):
    abar, bbar = _raw_projections(z + k, z, k, dtype)
    for got, want in zip(K.tracked_rr_plain(abar, bbar, k), _chain(abar, bbar, k)):
        assert got.dtype == dtype and torch.equal(got, want)


def test_wrappers_on_the_cpu_are_the_plain_versions():
    abar, bbar = _raw_projections(3, 2, 8, torch.float32)
    before = K.launch_counts()
    h, y, libar = K.tracked_rr(abar, bbar, 8)
    for got, want in zip((h, y, libar), K.tracked_rr_plain(abar, bbar, 8)):
        assert torch.equal(got, want)
    d, v = K.jacobi_eigh(h, 2)
    for got, want in zip(K.tracked_rr_coords(libar, y, d, v),
                         K.tracked_rr_coords_plain(libar, y, d, v)):
        assert torch.equal(got, want)
    assert K.launch_counts() == before  # no kernel on the CPU


def test_wrappers_refuse_what_they_do_not_take():
    abar, bbar = _raw_projections(4, 2, 8, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        K.tracked_rr(abar.half(), bbar.half(), 8)
    with pytest.raises(ValueError, match="tracked_rr takes"):
        K.tracked_rr(abar, bbar[:, :8].contiguous(), 8)
    with pytest.raises(ValueError, match="tracked_rr takes"):
        K.tracked_rr(abar, bbar, 17)
    with pytest.raises(ValueError, match="contiguous"):
        K.tracked_rr(abar.transpose(1, 2), bbar, 8)
    h, y, libar = K.tracked_rr(abar, bbar, 8)
    d, v = K.jacobi_eigh(h, 2)
    with pytest.raises(ValueError, match="tracked_rr_coords takes"):
        K.tracked_rr_coords(libar, y, d[:, :4], v)


def test_ops_under_vmap_equal_single_calls():
    """Three scenes of two zones: each op's vmap rule folds the scene axis
    into the zone axis (one call), and equals the scenes' own calls bit for
    bit."""
    pairs = [_raw_projections(10 + i, 2, 8, torch.float32) for i in range(3)]
    abar = torch.stack([p[0] for p in pairs])
    bbar = torch.stack([p[1] for p in pairs])
    h, y, libar = torch.func.vmap(K.tracked_rr, in_dims=(0, 0, None))(abar, bbar, 8)
    d, v = torch.func.vmap(lambda x: K.jacobi_eigh(x, 2))(h)
    c, lam = torch.func.vmap(K.tracked_rr_coords)(libar, y, d, v)
    for i in range(3):
        hi, yi, li = K.tracked_rr(abar[i], bbar[i], 8)
        di, vi = K.jacobi_eigh(hi, 2)
        ci, lami = K.tracked_rr_coords(li, yi, di, vi)
        for got, want in ((h[i], hi), (y[i], yi), (libar[i], li), (c[i], ci), (lam[i], lami)):
            assert torch.equal(got, want)


def _fake_basis(device, dtype, width):
    with FakeTensorMode():
        return torch.empty((2, 160, width), device=device, dtype=dtype)


@pytest.mark.parametrize(
    "device,dtype,width,kernel",
    [("cuda", torch.float32, 128, True), ("cuda", torch.float32, 16, True),
     ("cuda", torch.float64, 128, False), ("cuda", torch.float32, 136, False),
     ("cpu", torch.float32, 128, False)],
    ids=["card-f32-128", "card-f32-16", "card-f64", "card-f32-136", "cpu-f32"],
)
def test_dispatch_rule(device, dtype, width, kernel):
    """A float32 CUDA basis of 2k <= 128 columns takes the kernel; float64,
    a wider basis or the CPU take the torch chain (fake CUDA tensors: the
    rule reads only device, dtype and shape)."""
    assert J._rr_kernel_takes(_fake_basis(device, dtype, width)) is kernel


def test_the_solver_on_the_cpu_runs_the_chain(monkeypatch):
    """jdiag_topk_tracked takes its solve and coordinates by the rule: on
    the CPU the plain versions, once each an outer step."""
    ran = []

    def recorded(name, fn):
        def call(*args):
            ran.append(name)
            return fn(*args)
        return call

    for name in ("tracked_rr", "tracked_rr_coords", "tracked_rr_plain",
                 "tracked_rr_coords_plain"):
        monkeypatch.setattr(J, name, recorded(name, getattr(J, name)))
    rng = np.random.default_rng(2)
    z, n, k = 2, 40, 8
    x = torch.from_numpy(rng.standard_normal((z, n, n))).float()
    a = x @ x.transpose(1, 2) / n
    b = a + torch.eye(n)
    q0 = torch.linalg.qr(torch.from_numpy(rng.standard_normal((z, n, k))).float())[0]
    J.jdiag_topk_tracked(a, b, 1e-7, 4, q0.contiguous(), torch.ones(z, k),
                         torch.eye(n).repeat(z, 1, 1), False, outer_steps=2,
                         small_eigh="jacobi", jacobi_sweeps=2, rr_basis="direct")
    assert ran == ["tracked_rr_plain", "tracked_rr_coords_plain"] * 2


# -------------------------------------------------------------- on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32, 64])
@pytest.mark.parametrize("z", [2, 16, 32])
def test_kernel_within_twice_the_plain_error_against_float64(dev, z, k):
    abar, bbar = _raw_projections(100 + z + k, z, k, torch.float64, dev)
    before = K.tracked_rr.launches
    got = K.tracked_rr(abar.float(), bbar.float(), k)
    plain = K.tracked_rr_plain(abar.float(), bbar.float(), k)
    oracle = K.tracked_rr_plain(abar, bbar, k)
    torch.cuda.synchronize()
    assert K.tracked_rr.launches == before + 1
    for name, x, p, o in zip(("h", "y", "libar"), got, plain, oracle):
        assert x.shape == p.shape and x.device.type == "cuda"
        assert _rel(x, o) <= TOL_ORACLE_RATIO * _rel(p, o), (name, _rel(x, o), _rel(p, o))
    d, v = K.jacobi_eigh(got[0], 2)
    before = K.tracked_rr_coords.launches
    c, lam = K.tracked_rr_coords(got[2], got[1], d, v)
    cp, lamp = K.tracked_rr_coords_plain(got[2], got[1], d, v)
    torch.cuda.synchronize()
    assert K.tracked_rr_coords.launches == before + 1
    assert _rel(c, cp) <= 1e-4 and torch.equal(lam, lamp)


def _solver_inputs(seed, dev, fault):
    """Production-like solver inputs (half form, k = 16, n = 96) on the
    card; zone 1 made indefinite ("non-pd") or given a NaN ("nan")."""
    rng = np.random.default_rng(seed)
    z, n, k = 2, 96, 16
    x = rng.standard_normal((z, n, n)) / np.sqrt(n)
    y = rng.standard_normal((z, n, n)) / np.sqrt(n)
    a = np.tril(x @ np.swapaxes(x, 1, 2))
    b = np.tril(y @ np.swapaxes(y, 1, 2) + np.eye(n))
    a -= 0.5 * np.eye(n) * np.diagonal(a, axis1=1, axis2=2)[:, :, None]
    b -= 0.5 * np.eye(n) * np.diagonal(b, axis1=1, axis2=2)[:, :, None]
    if fault == "non-pd":
        b[1] = -b[1]
    else:
        a[1, 5, 2] = np.nan
    q0 = np.linalg.qr(rng.standard_normal((z, n, k)))[0]
    lam0 = np.abs(rng.standard_normal((z, k)))
    li0 = np.broadcast_to(np.eye(n), (z, n, n))
    t = lambda m: torch.from_numpy(np.ascontiguousarray(m)).float().to(dev)  # noqa: E731
    return t(a), t(b), t(q0), t(lam0), t(li0)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["non-pd", "nan"])
def test_failed_zone_is_nan_and_the_solver_reads_as_the_chain(dev, monkeypatch, fault):
    """The kernel gives a failed zone NaN in every entry of h, y and libar
    and leaves the other zone finite; through jdiag_topk_tracked, silenced
    and resid_rel then equal the torch chain's on the same card."""
    a, b, q0, lam0, li0 = _solver_inputs(7, dev, fault)
    abar, bbar = _raw_projections(8, 2, 16, torch.float32, dev)
    if fault == "non-pd":
        bbar[1] = -bbar[1]
    else:
        abar[1, 5, 2] = float("nan")
    out = K.tracked_rr(abar, bbar, 16)
    torch.cuda.synchronize()
    for x in out:
        assert torch.isnan(x[1]).all() and torch.isfinite(x[0]).all()
    args = (a, b, 1e-7, 8, q0, lam0, li0, False)
    kw = dict(outer_steps=1, small_eigh="jacobi", jacobi_sweeps=2, rr_basis="direct",
              half_form=True)
    before = K.tracked_rr.launches
    fused = J.jdiag_topk_tracked(*args, **kw)
    assert K.tracked_rr.launches == before + 1
    monkeypatch.setattr(J, "tracked_rr", K.tracked_rr_plain)
    monkeypatch.setattr(J, "tracked_rr_coords", K.tracked_rr_coords_plain)
    chain = J.jdiag_topk_tracked(*args, **kw)
    torch.cuda.synchronize()
    assert K.tracked_rr.launches == before + 1
    assert int(fused[5]) == int(chain[5]) > 0  # silenced
    assert float(fused[6]) == float(chain[6])  # resid_rel
    for x, y in zip(fused[:4], chain[:4]):
        assert torch.equal(torch.isfinite(x), torch.isfinite(y))


@pytest.mark.cuda
def test_launches_repeat_bit_for_bit(dev):
    """Two launches with other work on the stream between them, and two
    replays of a graph that holds the kernel, give the same bits."""
    abar, bbar = _raw_projections(21, 32, 64, torch.float32, dev)
    other = torch.randn(2, 2048, 2048, device=dev)
    first = K.tracked_rr(abar, bbar, 64)
    other = other @ other
    second = K.tracked_rr(abar, bbar, 64)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.tracked_rr(abar, bbar, 64)
    graph.replay()
    one = [x.clone() for x in out]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(one, out))
    assert all(torch.equal(x, y) for x, y in zip(one, first))


@pytest.mark.cuda
def test_each_production_graph_branch_launches_it_once(dev):
    """The graphed production hop (k = 22 at V = 8): each captured branch,
    the rebuild's and the carried one's, holds one launch of the kernel,
    one of K4 and one of the coordinates."""
    from apvast_torch import ApVast, production_overrides
    from apvast_torch.utils.rir import synthetic_rirs

    rir_a, rir_b = synthetic_rirs(96, 8, 3, seed=81), synthetic_rirs(96, 8, 3, seed=82)
    model = ApVast(128, rir_a, rir_b, 12, 4, 0, 5, 8, 1.0, 128, sampling_rate=8000,
                   perceptual=True, device=dev, **production_overrides())
    assert model.graphed and set(model.graph.launches) == {False, True}
    for branch, counts in model.graph.launches.items():
        assert counts["tracked_rr"] == 1, branch
        assert counts["jacobi_eigh"] == 1, branch
        assert counts["tracked_rr_coords"] == 1, branch
