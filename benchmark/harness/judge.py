"""The comparison that decides ``correct``, run once the window has closed
and the program's state is freed.

For each judged hop t (:func:`harness.drive.judged_hops`) and each stream,
the reference (``benchmark/reference``) works out in float64, from the
stream's responses and program alone, the weighted statistics buffers, the
pencils and the cross vectors of hops t - 1 and t. It judges what the
timed path left, the worst over zones, streams and judged hops:

* ``stat_gap``: the state's weighted statistics buffers after hop t (K1's
  responses, the perceptual weighting, the WOLA products);
* ``feed1_gap``, ``feed_gap``: the feeds of hop t at span 1 and at span V
  (the fetched span) against those the reference synthesizes from the
  program's eigenvectors of hops t - 1 and t with its own cross vector and
  Rayleigh quotients on A (K2 and K3's statistics, the filters, K5's
  synthesis);
* ``step_deficit``: the filter design (the tracking solver with K4). The
  reference takes the Ritz basis that hop t - 1 left in the program's state
  and makes hop t's solver step itself, in float64 on its own pencils,
  with the preconditioner of the last rebuild hop worked out from its own
  dark matrix and the small eigenproblem given the configured number of
  Jacobi sweeps (``reference/jacobi.py``, in float64). The number is 1 -
  the sum of the Rayleigh quotients of the program's V vectors of hop t
  over that of the reference step's, on hop t's pencils: what the
  program's step lost of the eigenvalue sum that the same step reaches in
  float64. A K4 that does not rotate, or a tracker that stops widening its
  subspace, loses much more than rounding does.

The gaps are each the widest gap as a share of the largest reference
value. Those with a limit in the configuration's ``limits`` are compared.
Printed, not compared: ``lam_gap``, the state's Ritz values against the
Rayleigh quotients of its vectors (the float32 vectors' B-norms, which the
filters absorb), and ``ritz_deficit``, 1 - the sum of the program's V
Rayleigh quotients over the sum of the exact top V generalized eigenvalues
of hop t's pencils (the first stream): how far the tracked subspace lies
from the exact one, which the tracker's design leaves at several percent
and more under level steps, with or without a fault.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.hop import (
    F64,
    Semantics,
    Tables,
    exact_top,
    feeds,
    inverse_cholesky,
    rayleigh,
    segment_bounds,
    span_filter,
    statistics_pair,
    tracking_step,
)

# The tracker's jitter on its Rayleigh-Ritz Gram matrix: 8 units of
# rounding of the configuration's precision, relative to its mean diagonal.
JITTER_EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52}


def _segment(progs: np.ndarray, stream: int, start: int, stop: int, device) -> torch.Tensor:
    """Stream samples [start, stop) of both programs: the program played
    cyclically, silence before the stream's first sample."""
    period = progs.shape[-1]
    n = np.arange(start, stop)
    x = progs[stream][:, n % period].astype(np.float64)
    x[:, n < 0] = 0.0
    return torch.as_tensor(x, device=device)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap as a share of the largest reference value, the worse
    of the two zones."""
    dims = tuple(range(1, want.dim()))
    gap = (got - want).abs().amax(dims) / want.abs().amax(dims).clamp_min(1e-300)
    return float(gap.max())


def last_rebuild(flags: list[bool], t: int) -> int:
    """The last hop at or before ``t`` that refreshed the tracker's
    preconditioner (``flags[tau]`` is hop tau's rebuild flag)."""
    return max(tau for tau in range(t + 1) if flags[tau])


def judge(config: dict, rirs: list, progs: np.ndarray, record: dict, judged: list[int],
          device) -> dict:
    """Every number worked out (``numbers``), those with a limit in the
    configuration's ``limits`` compared (``compared``), and what was
    judged."""
    sem = Semantics.from_config(config)
    tables = Tables(sem, device)
    jitter = 8.0 * JITTER_EPS[config["scene"]["dtype"]]
    sweeps = config["reference"]["jacobi_sweeps"]
    snaps, kept, flags = record["snaps"], record["feeds"], record["rebuilt_tau"]
    done = [t for t in judged if t in kept and t - 1 in snaps]
    nums = dict(stat_gap=0.0, feed1_gap=0.0, feed_gap=0.0, step_deficit=-1.0, lam_gap=0.0,
                ritz_deficit=0.0)
    v = sem.num_eigenvectors

    def worse(name, value):
        nums[name] = max(nums[name], value)

    def pencils_of(i, rir, t):
        seg = _segment(progs, i, *segment_bounds(sem, t), device)
        return seg, statistics_pair(sem, tables, rir, seg)

    lis = {}
    for t in done:
        r = last_rebuild(flags, t)
        for i, (ra, rb) in enumerate(rirs):
            rir = torch.as_tensor(np.stack([ra, rb]), device=device, dtype=F64)
            seg, pencils = pencils_of(i, rir, t)
            cur, prev, ref = snaps[t], snaps[t - 1], pencils[1]
            j = sem.filter_length
            e = torch.cat([ref["stat"][..., :j], ref["stat"][..., j + 1:]], dim=-1)
            worse("stat_gap", max(_gap(cur["stat"][i].to(F64), e),
                                  _gap(cur["tstat"][i].to(F64), ref["tstat"])))
            filters, filters1 = [], []
            for k, snap in enumerate((prev, cur)):
                q, lam = snap["q"][i, ..., :v].to(F64), snap["lam"][i, ..., :v].to(F64)
                rho = rayleigh(q, pencils[k])
                worse("lam_gap", _gap(lam, rho))
                filters.append(span_filter(sem, q, pencils[k]))
                filters1.append(span_filter(sem, q[..., :1], pencils[k]))
            want = feeds(sem, tables, seg, *filters)
            worse("feed_gap", _gap(torch.as_tensor(kept[t][i], device=device, dtype=F64), want))
            want1 = feeds(sem, tables, seg, *filters1)
            worse("feed1_gap", _gap(cur["rank1"][i].to(F64), want1))
            # The solver: hop t's step from the state hop t - 1 left, with
            # the preconditioner of the last rebuild, against the program's.
            if (i, r) not in lis:
                lis[i, r] = inverse_cholesky(pencils[1] if r == t else pencils[0] if r == t - 1
                                             else pencils_of(i, rir, r)[1][1])
            li = lis[i, r]
            q_ref, _ = tracking_step(ref, prev["q"][i].to(F64), prev["lam"][i].to(F64), li,
                                     jitter, sweeps)
            rho = rayleigh(cur["q"][i, ..., :v].to(F64), ref).sum(-1)
            rho_ref = rayleigh(q_ref[..., :v], ref).sum(-1)
            worse("step_deficit", float((1.0 - rho / rho_ref).max()))
            if i == 0:
                exact, _ = exact_top(sem, ref)
                worse("ritz_deficit", float((1.0 - rho / exact.sum(-1)).max()))
    limits = config["limits"]
    ok = bool(done) and all(nums[k] <= limits[k] for k in limits)
    return dict(
        correct=ok, judged=done, streams=len(rirs), numbers=nums,
        compared={k: {"value": nums[k], "limit": limits[k]} for k in limits},
    )
