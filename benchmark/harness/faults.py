"""Faults planted underneath the timed path, each one a way the program
could go wrong that the comparison (``harness/judge.py``) has to catch.

Each returns ``undo()``, which puts back what it replaced. Those in
``BEFORE_BUILD`` replace a function of the program's modules and take the
cell: they are planted before the model is built, so that the CUDA graph
that the model captures when it is built holds them. Those in
``AFTER_BUILD`` replace a method of the built model (``Built``), which
only the eager hop calls: the CPU's. ``benchmark/tests/test_bench_harness.py``
plants each on the CPU and sees ``correct`` come out false; ``run.py
--control <name>`` plants one of ``BEFORE_BUILD`` on the card, to read the
comparison's numbers at a cell's own size. The benchmark's own runs plant
none.
"""

from __future__ import annotations

import importlib

import torch


def _jdiag():
    # ``apvast_torch.ops`` exports a function named ``jdiag``: the module
    # is found by its full name.
    return importlib.import_module("apvast_torch.ops.jdiag")


def _swap(module, name: str, fn):
    """Replace ``module.name`` by ``fn``; return the undo."""
    old = getattr(module, name)
    setattr(module, name, fn)
    return lambda: setattr(module, name, old)


def state_unchanged(built):
    """Every hop returns the state it was given."""
    model = built.model
    if built.batched:
        hop = model._hop

        def frozen(plan, state, a, b, **kw):
            return state, hop(plan, state, a, b, **kw)[1]

        model._hop = frozen
        return lambda: setattr(model, "_hop", hop)
    eager = model._eager_hop

    def frozen_one(a, b):
        state = model._state
        out = eager(a, b)
        model._state = state
        return out

    model._eager_hop = frozen_one
    return lambda: setattr(model, "_eager_hop", eager)


def half_batch(built):
    """Half the batch left out, the mean taken over the rest: half the
    scenes (several streams) or half the microphones' statistics, doubled
    (one stream)."""
    import apvast_torch.engine.hop as hop_mod

    model = built.model
    if built.batched:
        hop = model._hop

        def half(plan, state, a, b, **kw):
            new, out = hop(plan, state, a, b, **kw)
            k = out.out_a.shape[0] // 2
            out.out_a[k:] = out.out_a[:k]
            out.out_b[k:] = out.out_b[:k]
            return new, out

        model._hop = half
        return lambda: setattr(model, "_hop", hop)
    stats = hop_mod.hop_statistics

    def half_one(config, wresp, wtarget, mic_axis=None):
        k = wresp.shape[1] // 2
        r_mats, r_vecs = stats(config, wresp[:, :k], wtarget[:, :k], mic_axis)
        scale = wresp.shape[1] / k
        return r_mats * scale, r_vecs * scale

    return _swap(hop_mod, "hop_statistics", half_one)


def answer_altered(cell):
    """Loudspeaker 0's feeds, every span's, produced with their sign
    flipped (kernel K5's output)."""
    import apvast_torch.engine.hop as hop_mod

    synth = hop_mod.circular_filter_overlap
    s = cell.config["scene"]["num_srcs"]

    def altered(*args):
        emit, tail = synth(*args)
        emit = emit.clone()
        emit.view(emit.shape[0], -1, s, emit.shape[-1])[:, :, 0] *= -1
        return emit, tail

    return _swap(hop_mod, "circular_filter_overlap", altered)


def k4_no_sweeps(cell):
    """Kernel K4 run with no Jacobi sweep: the tracking solver's small
    Rayleigh-Ritz matrices come back unrotated, their diagonal taken for
    the eigenvalues (sorted, as the kernel returns them)."""
    jdiag_mod = _jdiag()
    small = jdiag_mod._small_eigh

    def unrotated(h, small_eigh, jacobi_sweeps):
        return small(h, small_eigh, 0)

    return _swap(jdiag_mod, "_small_eigh", unrotated)


def tracker_stalled(cell):
    """The tracking solver stops widening its subspace: on every hop that
    does not rebuild, the new Ritz pairs are those of the incoming basis's
    own span on this hop's pencil (Rayleigh-Ritz on X alone, solved with
    K4 at 8 sweeps), so the filters stay consistent with their vectors and
    eigenvalues while the subspace no longer follows the statistics. Its
    residual, which steers the rebuilds, is the solver's own."""
    import apvast_torch.engine.hop as hop_mod

    jdiag_mod = _jdiag()
    tracked = hop_mod.jdiag_topk_tracked

    def stalled(A, B, reg, v, q_init, lam_init, li_carry, rebuild, **kw):
        out = tracked(A, B, reg, v, q_init, lam_init, li_carry, rebuild, **kw)
        if rebuild:
            return out
        _, _, _, _, li, silenced, resid = out
        q = q_init
        if kw.get("half_form"):
            aq = A @ q + A.transpose(-1, -2) @ q
            bq = B @ q + B.transpose(-1, -2) @ q + reg * q
        else:
            aq, bq = A @ q, B @ q + reg * q
        qt = q.transpose(-1, -2)
        abar = 0.5 * (qt @ aq + (qt @ aq).transpose(-1, -2))
        bbar = 0.5 * (qt @ bq + (qt @ bq).transpose(-1, -2))
        k = bbar.shape[-1]
        eye = torch.eye(k, dtype=bbar.dtype, device=bbar.device)
        tr = torch.diagonal(bbar, dim1=-2, dim2=-1).sum(-1) / k
        bbar = bbar + (8.0 * torch.finfo(bbar.dtype).eps * tr)[:, None, None] * eye
        lib = jdiag_mod.triangular_inverse(jdiag_mod.cholesky(bbar))
        w = lib @ abar @ lib.transpose(-1, -2)
        w = 0.5 * (w + w.transpose(-1, -2))
        d, vec = jdiag_mod._small_eigh(w, kw.get("small_eigh", "jacobi"), 8)
        q_new = q @ (lib.transpose(-1, -2) @ vec.flip(-1))
        lam_new = d.flip(-1)
        return q_new[..., :v], lam_new[..., :v], q_new, lam_new, li, silenced, resid

    return _swap(hop_mod, "jdiag_topk_tracked", stalled)


BEFORE_BUILD = {f.__name__: f for f in (answer_altered, k4_no_sweeps, tracker_stalled)}
AFTER_BUILD = {f.__name__: f for f in (state_unchanged, half_batch)}
PLANT = {**BEFORE_BUILD, **AFTER_BUILD}
