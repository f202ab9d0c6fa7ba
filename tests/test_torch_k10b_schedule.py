"""K10b's schedule, emulated on the CPU in torch.

The kernel (``apvast_torch/csrc/chol_tri_inverse.cu``) runs its panel
factorizations (F), panel solves (S), trailing updates (U) and inverse
tiles (I) on blocks joined by ready counters instead of grid barriers:
role F (one block a matrix), role C (the look-ahead: the next row block's
solve bands and the next diagonal tile's update bands) and a pool that
takes tickets in the order of ``decode``. This module repeats that
schedule in Python, block by block, with the kernel's wait conditions on
the counters, in random interleavings and with pools of different sizes:

- every task reads only finished inputs: beside the counters, a ledger
  records what each task has written (panel updates applied to each entry,
  solved rows of L, finished tiles of X), and each task checks it before it
  reads;
- no interleaving deadlocks, and every ticket decodes to a distinct task;
- the result, computed tile by tile with the kernel's splits of each sum,
  reproduces ``chol_tri_inverse_plain``: within 1e-5 of scale (the
  plain-version bound of ``chip_smoke.py``'s ``TOL_CHOL_TRI``), exact zeros
  above the diagonal, and the same non-finite entries in the lower
  triangle on non-PD input.
"""

import random

import numpy as np
import pytest
import torch

from apvast_torch.ops import kernels as K
from apvast_torch.ops.kernels.whiten import _pad_identity, _panel_factor
from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

PANEL, BANDS, BAND, COLS, HALF, CHUNK = 128, 16, 8, 16, 64, 32


def decode(t, bz, panels):
    """csrc/chol_tri_inverse.cu::decode: the pool's ticket t as a task."""
    for s in range(panels - 1):
        ns = (panels - 2 - s) * BANDS
        tiles = [(q, r) for r in range(s + 1, panels) for q in range(max(r, s + 2), panels)]
        nu = sum(3 if q == r else 4 for q, r in tiles)
        ni = (s + 1) * PANEL // COLS
        if t < bz * ns:
            return ("S", t // ns, s, s + 2 + (t % ns) // BANDS, t % BANDS)
        t -= bz * ns
        if t < bz * nu:
            b, i = divmod(t, nu)
            for q, r in tiles:
                k = 3 if q == r else 4
                if i < k:
                    sub = (0 if i == 0 else i + 1) if q == r else i
                    return ("U", b, s, q, r, sub)
                i -= k
        t -= bz * nu
        if t < bz * ni:
            return ("I", t // ni, s + 1, t % ni)
        t -= bz * ni
    return None


def diag_ready(p):
    """U tasks on tile (p, p) once every earlier panel's update is done."""
    return 0 if p == 0 else 3 * (p - 1) + BANDS


class Emulation:
    """The kernel's workspace, counters and tasks for one launch, with the
    ledger of what is written."""

    def __init__(self, b):
        self.bz, self.n, _ = b.shape
        self.npad = -(-self.n // PANEL) * PANEL
        self.panels = self.npad // PANEL
        self.a = _pad_identity(b, self.npad).clone()
        self.x = torch.full_like(self.a, float("nan"))  # never read before written
        self.out = torch.full_like(b, float("nan"))
        for r in range(self.n):  # the copy-in zeroes the blocks above the block diagonal
            self.out[:, r, (r // PANEL + 1) * PANEL:] = 0.0
        p_, t_ = self.panels, self.npad // COLS
        self.f = np.zeros((self.bz, p_), int)
        self.s = np.zeros((self.bz, p_, p_), int)
        self.u = np.zeros((self.bz, p_, p_), int)
        self.i = np.zeros((self.bz, p_, t_), int)
        self.ticket = 0
        # The ledger: panel updates applied to each entry of A; rows of L
        # solved, by panel; tiles of X finished; tasks run.
        self.applied = torch.zeros(self.a.shape, dtype=torch.int32)
        self.solved = np.zeros((self.bz, p_, self.npad), bool)
        self.x_done = np.zeros((self.bz, p_, t_), bool)
        self.done = []

    # -- the ledger's checks -------------------------------------------------
    def _updated(self, b, rows, cols, count, lower_only=False):
        got = self.applied[b, rows, cols]
        if lower_only:
            r = torch.arange(rows.start, rows.stop)[:, None]
            c = torch.arange(cols.start, cols.stop)[None, :]
            got = got[r >= c]
        assert bool((got == count).all()), f"read entries with {got.unique()} updates, want {count}"

    def _rows_solved(self, b, p, rows):
        assert self.solved[b, p, rows].all(), f"read unsolved rows of L[:, {p}]"

    # -- the tasks (each reads what the ledger says is final) -----------------
    def f_task(self, b, p):
        lo, hi = p * PANEL, (p + 1) * PANEL
        self._updated(b, slice(lo, hi), slice(lo, hi), p, lower_only=True)
        lp, lpinv = _panel_factor(self.a[b:b + 1, lo:hi, lo:hi])
        self.a[b, lo:hi, lo:hi] = lp[0]
        self.x[b, lo:hi, lo:hi] = lpinv[0]
        m = max(0, min(hi, self.n) - lo)
        self.out[b, lo:lo + m, lo:lo + m] = torch.tril(lpinv[0, :m, :m])
        self.x_done[b, p, lo // COLS:hi // COLS] = True
        self.solved[b, p, lo:hi] = True
        self.done.append(("F", b, p))

    def s_task(self, b, p, q, h):
        lo, hi = p * PANEL, (p + 1) * PANEL
        rows = slice(q * PANEL + h * BAND, q * PANEL + (h + 1) * BAND)
        assert self.f[b, p] and self.solved[b, p, lo:hi].all()
        self._updated(b, rows, slice(lo, hi), p)
        a21, lp, li = self.a[b, rows, lo:hi].clone(), self.a[b, lo:hi, lo:hi], self.x[b, lo:hi, lo:hi]

        def nt(x, y):  # four k-groups of 32, added in group order
            acc = x[:, :32] @ y[:, :32].T
            for g in range(1, 4):
                acc = acc + x[:, 32 * g:32 * g + 32] @ y[:, 32 * g:32 * g + 32].T
            return acc

        t1 = nt(a21, li)
        res = a21 - nt(t1, lp)
        self.a[b, rows, lo:hi] = t1 + nt(res, li)
        self.solved[b, p, rows] = True
        self.done.append(("S", b, p, q, h))

    def u_band(self, b, p, h):
        lo, hi, q0 = p * PANEL, (p + 1) * PANEL, (p + 1) * PANEL
        self._rows_solved(b, p, slice(q0, q0 + PANEL))
        rows = slice(q0 + h * BAND, q0 + (h + 1) * BAND)
        self._updated(b, rows, slice(q0, q0 + PANEL), p, lower_only=True)
        lq = self.a[b, q0:q0 + PANEL, lo:hi]
        band = lq[h * BAND:(h + 1) * BAND]
        acc = band[:, :32] @ lq[:, :32].T
        for g in range(1, 4):
            acc = acc + band[:, 32 * g:32 * g + 32] @ lq[:, 32 * g:32 * g + 32].T
        r = torch.arange(rows.start, rows.stop)[:, None]
        c = torch.arange(q0, q0 + PANEL)[None, :]
        keep = r >= c
        tile = self.a[b, rows, q0:q0 + PANEL]
        self.a[b, rows, q0:q0 + PANEL] = torch.where(keep, tile - acc, tile)
        self.applied[b, rows, q0:q0 + PANEL] += keep.int()
        self.done.append(("UC", b, p, h))

    def u_sub(self, b, p, q, r, sub):
        lo, hi = p * PANEL, (p + 1) * PANEL
        si, sj = divmod(sub, 2)
        ra, rb = q * PANEL + HALF * si, r * PANEL + HALF * sj
        self._rows_solved(b, p, slice(ra, ra + HALF))
        self._rows_solved(b, p, slice(rb, rb + HALF))
        self._updated(b, slice(ra, ra + HALF), slice(rb, rb + HALF), p, lower_only=q == r)
        la, lb = self.a[b, ra:ra + HALF, lo:hi], self.a[b, rb:rb + HALF, lo:hi]
        acc = la[:, :HALF] @ lb[:, :HALF].T + la[:, HALF:] @ lb[:, HALF:].T
        self.a[b, ra:ra + HALF, rb:rb + HALF] -= acc
        self.applied[b, ra:ra + HALF, rb:rb + HALF] += 1
        self.done.append(("U", b, p, q, r, sub))

    def i_phase1(self, b, p, jt):
        lo, c0 = p * PANEL, jt * COLS
        jb = c0 // PANEL
        cols = slice(c0, c0 + COLS)
        for k in range(jb, p):
            self._rows_solved(b, k, slice(lo, lo + PANEL))
            assert self.x_done[b, k, jt], f"inverse tile ({p}, {jt}) read X[{k}] unfinished"
        acc = [torch.zeros(PANEL, COLS), torch.zeros(PANEL, COLS)]
        for k0 in range(c0, lo, CHUNK):
            for g in range(2):  # two k-groups, 16 deep in each chunk
                kg = k0 + 16 * g
                if kg < lo:
                    acc[g] = acc[g] + self.a[b, lo:lo + PANEL, kg:kg + 16] @ self.x[b, kg:kg + 16, cols]
        return acc[0] + acc[1]

    def i_phase2(self, b, p, jt, s):
        lo, hi, c0 = p * PANEL, (p + 1) * PANEL, jt * COLS
        assert self.f[b, p] and self.x_done[b, p, lo // COLS]
        lp, li = self.a[b, lo:hi, lo:hi], self.x[b, lo:hi, lo:hi]

        def nn(x, y):  # two k-groups of 64
            return x[:, :HALF] @ y[:HALF] + x[:, HALF:] @ y[HALF:]

        xi = -nn(li, s)
        res = -s - nn(lp, xi)
        xi = xi + nn(li, res)
        self.x[b, lo:hi, c0:c0 + COLS] = xi
        m = max(0, min(hi, self.n) - lo)
        self.out[b, lo:lo + m, c0:c0 + COLS] = xi[:m]
        self.x_done[b, p, jt] = True
        self.done.append(("I", b, p, jt))

    # -- the blocks: generators that yield their wait conditions ---------------
    def f_block(self, b):
        for p in range(self.panels):
            yield lambda p=p: self.u[b, p, p] >= diag_ready(p)
            self.f_task(b, p)
            self.f[b, p] += 1

    def c_block(self, b, h):
        for p in range(self.panels - 1):
            yield lambda p=p: self.f[b, p] >= 1 and self.u[b, p + 1, p] >= 4 * p
            self.s_task(b, p, p + 1, h)
            self.s[b, p, p + 1] += 1
            yield lambda p=p: self.s[b, p, p + 1] >= BANDS and self.u[b, p + 1, p + 1] >= 3 * p
            self.u_band(b, p, h)
            self.u[b, p + 1, p + 1] += 1

    def pool_block(self):
        while True:
            yield lambda: True  # the ticket is taken when the block runs
            task = decode(self.ticket, self.bz, self.panels)
            self.ticket += 1
            if task is None:
                return
            kind, b, p = task[:3]
            if kind == "S":
                q, h = task[3:]
                yield lambda: self.f[b, p] >= 1 and self.u[b, q, p] >= 4 * p
                self.s_task(b, p, q, h)
                self.s[b, p, q] += 1
            elif kind == "U":
                q, r, sub = task[3:]
                yield lambda: (self.s[b, p, q] >= BANDS and self.s[b, p, r] >= BANDS
                               and self.u[b, q, r] >= (3 if q == r else 4) * p)
                self.u_sub(b, p, q, r, sub)
                self.u[b, q, r] += 1
            else:
                jt = task[3]
                jb = jt * COLS // PANEL
                yield lambda: (self.f[b, jb] >= 1
                               and all(self.i[b, k, jt] >= 1 for k in range(jb + 1, p))
                               and all(self.s[b, k, p] >= BANDS for k in range(jb, p)))
                s = self.i_phase1(b, p, jt)
                yield lambda: self.f[b, p] >= 1
                self.i_phase2(b, p, jt, s)
                self.i[b, p, jt] += 1

    def run(self, pool, seed):
        """Run every block to its end, picking at random among the blocks
        whose wait condition holds; fail on a deadlock."""
        rng = random.Random(seed)
        blocks = [self.f_block(b) for b in range(self.bz)]
        if self.panels > 1:
            blocks += [self.c_block(b, h) for b in range(self.bz) for h in range(BANDS)]
            blocks += [self.pool_block() for _ in range(pool)]
        waits = {}
        for blk in blocks:
            waits[blk] = next(blk)
        while waits:
            ready = [blk for blk, cond in waits.items() if cond()]
            assert ready, "deadlock: no block's wait condition holds"
            blk = rng.choice(ready)
            try:
                waits[blk] = next(blk)
            except StopIteration:
                del waits[blk]
        return self.out


def _spd(bz, n, seed, bad=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bz, n, n)).astype(np.float32)
    b = x @ x.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32)
    if bad is not None:
        b[-1, bad, bad] = -1.0
    return torch.from_numpy(b)


def _expected_tasks(bz, panels):
    n_s = sum(panels - 1 - p for p in range(panels)) * BANDS
    n_u = sum(3 if q == r else 4 for p in range(panels) for r in range(p + 1, panels)
              for q in range(r, panels)) - (panels - 1) * 3
    n_i = sum(p * PANEL // COLS for p in range(panels))
    return bz * (panels + n_s + (panels - 1) * BANDS + n_u + n_i)


@pytest.mark.parametrize("panels", [1, 2, 5, 8])
def test_tickets_decode_to_distinct_tasks(panels):
    bz = 3
    tasks = []
    t = 0
    while (task := decode(t, bz, panels)) is not None:
        tasks.append(task)
        t += 1
    assert len(set(tasks)) == len(tasks)
    n_pool_s = bz * sum(panels - 2 - s for s in range(panels - 1)) * BANDS
    assert sum(1 for x in tasks if x[0] == "S") == n_pool_s
    assert sum(1 for x in tasks if x[0] == "I") == bz * sum(p * PANEL // COLS for p in range(panels))
    # Role C takes the solves of row block p + 1 and the updates of tile (p + 1, p + 1).
    assert not any(x[0] == "S" and x[3] == x[2] + 1 for x in tasks)
    assert not any(x[0] == "U" and x[3] == x[4] == x[2] + 1 for x in tasks)


@pytest.mark.parametrize(
    "bz,n,pool,seed",
    [(2, 800, 114, 0), (1, 1024, 1, 1), (3, 300, 7, 2), (1, 128, 1, 3), (2, 256, 2, 4)],
    ids=["2x800", "1x1024-one-pool-block", "3x300", "one-panel", "two-panels"],
)
def test_schedule_reads_finished_inputs_and_matches_plain(bz, n, pool, seed):
    b = _spd(bz, n, seed)
    emu = Emulation(b)
    got = emu.run(pool, seed)
    assert len(emu.done) == _expected_tasks(bz, emu.panels)
    want = K.chol_tri_inverse_plain(b)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))


@pytest.mark.parametrize("n,bad", [(200, 70), (300, 150), (800, 300), (640, 600)],
                         ids=["panel0", "panel1-first-sub", "panel2-second-sub", "last-panel"])
def test_non_pd_gives_the_plain_non_finite_pattern(n, bad):
    b = _spd(2, n, n, bad=bad)
    got = Emulation(b).run(5, n)
    want = K.chol_tri_inverse_plain(b)
    lower = torch.ones(n, n, dtype=torch.bool).tril()
    assert torch.isfinite(got[0]).all()
    assert not torch.isfinite(got[1]).all()
    assert torch.equal(torch.isfinite(got[1])[lower], torch.isfinite(want[1])[lower])
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    assert float((got[0] - want[0]).abs().max() / want[0].abs().max()) <= 1e-5
