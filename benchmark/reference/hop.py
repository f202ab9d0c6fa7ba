"""The time-domain AP-VAST hop's mathematics in float64, for judging a
stream at any hop from a short run-in of its program.

A hop's statistics depend only on the last few hops of the program: the
RIR filter state (``rir_length - 1`` samples), the weighting's overlap-add
(the block before) and the statistics buffer (the last ``buffer`` samples
of the weighted emits). So the statistics of two consecutive hops t - 1
and t, and the loudspeaker feeds of hop t, follow from the program over
samples ``[(t - 4) hop - (rir_length - 1), (t + 1) hop)``: see
:func:`segment_bounds`.

Stages, as the reference engine defines them (the reference repository's
``Python/apvast.py``; the JAX package's ``oracle/reference_np.py`` holds
the same semantics in NumPy with SciPy's filters):

1. the responses of every (program, zone, loudspeaker, microphone) path and
   of the modeling-delayed reference loudspeaker, by linear convolution;
2. the target blocks' perceptual weighting (van de Par, unit one-sided
   norm), windowed (sine window) and overlap-added at 50 %;
3. the responses weighted by their destination zone's weighting, the same
   way;
4. the statistics: per path the Toeplitz stack of the last ``buffer``
   weighted samples with sample J left out (the reference's SciPy
   ``toeplitz`` corner), R = sum over microphones of Y Y^T and r = Y d;
5. the pencils (bright, dark) of each zone, the dark matrix loaded by
   ``reg_b_relative`` times its mean diagonal plus ``reg_b``; the
   variable-span filter of span V from given generalized eigenvectors;
6. the loudspeaker feeds: the windowed input block circularly filtered by
   each loudspeaker's J taps, windowed and overlap-added.

and of the production solver, the top-k subspace tracker (the JAX
package's ``jdiag_topk_tracked``, one outer step a hop): one step of it
from a given Ritz basis, with the inverse Cholesky factor of the dark
matrix of the last rebuild hop and the configured Jacobi sweeps on the
small eigenproblem.

Everything is batched over zones, microphones and loudspeakers and runs on
the device of its inputs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from reference.jacobi import jacobi_eigh
from reference.perceptual import build_perceptual_tables

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class Semantics:
    """What the reference needs of a configuration (its file's ``scene``
    and ``reference`` groups)."""

    num_srcs: int
    num_mics: int
    rir_length: int
    block_size: int
    filter_length: int
    modeling_delay: int
    reference_index_a: int
    reference_index_b: int
    num_eigenvectors: int
    mu: float
    statistics_buffer_length: int
    sampling_rate: int
    perceptual: bool
    pressure_scale_db_spl: float
    threshold_method: str
    reg_b: float
    reg_b_relative: float

    @property
    def hop(self) -> int:
        return self.block_size // 2

    @property
    def jl(self) -> int:
        return self.num_srcs * self.filter_length

    @classmethod
    def from_config(cls, config: dict) -> "Semantics":
        scene, ref = config["scene"], config["reference"]
        fields = {f.name for f in dataclasses.fields(cls)}
        merged = {**scene, **ref}
        sem = cls(**{k: merged[k] for k in fields})
        if ref.get("weighting_norm") != "unit_onesided":
            raise ValueError("the reference implements the unit one-sided weighting norm only")
        if ref.get("target_filter") != "shared_a" or ref.get("toeplitz") != "python":
            raise ValueError("the reference implements the shared zone-A target filter and "
                             "the reference's Toeplitz stack only")
        if sem.statistics_buffer_length > sem.block_size:
            raise ValueError("the statistics buffer must fit in two emits (buffer <= block)")
        return sem


class Tables:
    """The window and the perceptual tables on a device, in float64."""

    def __init__(self, sem: Semantics, device):
        n = sem.block_size
        self.window = torch.sin(math.pi / n * torch.arange(n, dtype=F64, device=device))
        self.perceptual = sem.perceptual
        if sem.perceptual:
            t = build_perceptual_tables(n, float(sem.sampling_rate), sem.pressure_scale_db_spl,
                                        sem.threshold_method)
            self.cfmr_sq = torch.as_tensor(t.cfmr_sq, dtype=F64, device=device)
            self.cs, self.ca, self.leff = t.cs, t.ca, t.leff
            self.spectrum_scale = t.spectrum_scale


def segment_bounds(sem: Semantics, t: int) -> tuple[int, int]:
    """Stream samples ``[start, stop)`` that the statistics of hops t - 1
    and t and the feeds of hop t need (``start`` may be negative: the
    stream is silent before its first sample)."""
    h = sem.hop
    return (t - 4) * h - (sem.rir_length - 1), (t + 1) * h


def _gain(tables: Tables, spec: torch.Tensor) -> torch.Tensor:
    """Unit one-sided van de Par weighting of raw one-sided spectra
    (..., bins)."""
    if not tables.perceptual:
        return torch.ones(spec.shape, dtype=F64, device=spec.device)
    power = (spec * tables.spectrum_scale).abs() ** 2
    masker = power @ tables.cfmr_sq
    g = torch.sqrt(tables.cs * tables.leff * ((1.0 / (masker + tables.ca)) @ tables.cfmr_sq.T))
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def _target_rirs(sem: Semantics, rirs: torch.Tensor) -> torch.Tensor:
    """(2, rir_length, M): each zone's reference loudspeaker's responses,
    delayed by the modeling delay."""
    d = sem.modeling_delay
    refs = (sem.reference_index_a, sem.reference_index_b)
    out = torch.zeros((2, sem.rir_length, sem.num_mics), dtype=F64, device=rirs.device)
    for z, ref in enumerate(refs):
        out[z, d:] = rirs[z, : sem.rir_length - d, ref, :]
    return out


def statistics_pair(sem: Semantics, tables: Tables, rirs: torch.Tensor,
                    segment: torch.Tensor) -> list[dict]:
    """The pencils and cross vectors of hops t - 1 and t.

    ``rirs`` (2, rir_length, S, M) float64, zone A then zone B;
    ``segment`` (2, stop - start) float64, the programs over
    :func:`segment_bounds`. Returns two dicts (hop t - 1, hop t) of
    ``a`` (2, JL, JL) bright, ``b`` (2, JL, JL) loaded dark, ``r`` (2, JL),
    by zone, and ``stat`` (4, M, S, buffer), ``tstat`` (2, M, buffer) the
    weighted buffers."""
    h, n, j = sem.hop, sem.statistics_buffer_length, sem.filter_length
    L, s, m = sem.rir_length, sem.num_srcs, sem.num_mics
    block = sem.block_size
    lseg = segment.shape[-1]
    nfft = 1 << (lseg + L - 2).bit_length()
    xs = torch.fft.rfft(segment, n=nfft)  # (2, F)
    # Paths 0=A->A, 1=A->B, 2=B->A, 3=B->B (program -> destination zone).
    rir_spec = torch.fft.rfft(rirs.permute(0, 3, 2, 1), n=nfft)  # (2, M, S, F)
    tgt_spec = torch.fft.rfft(_target_rirs(sem, rirs).permute(0, 2, 1), n=nfft)  # (2, M, F)
    valid = slice(L - 1, lseg)  # samples (t - 4) hop ... (t + 1) hop
    resp = torch.stack([
        torch.fft.irfft(xs[sig] * rir_spec[dest], n=nfft)[..., valid]
        for sig, dest in ((0, 0), (0, 1), (1, 0), (1, 1))
    ])  # (4, M, S, 5 hop)
    tresp = torch.fft.irfft(xs[:, None, :] * tgt_spec, n=nfft)[..., valid]  # (2, M, 5 hop)
    win = tables.window
    news_t, news_r = [], []
    for k in range(4):  # blocks of hops t - 3 .. t
        rows = slice(k * h, k * h + block)
        tspec = torch.fft.rfft(win * tresp[..., rows])
        g = _gain(tables, tspec)  # (2, M, bins)
        news_t.append(win * torch.fft.irfft(tspec * g, n=block))
        rspec = torch.fft.rfft(win * resp[..., rows])
        gp = torch.cat([g, g])[:, :, None, :]  # path p weighted by zone p % 2
        news_r.append(win * torch.fft.irfft(rspec * gp, n=block))
    out = []
    for k in (2, 3):  # hops t - 1, t: the last two emits
        def buffer(news):
            emits = [news[i - 1][..., h:] + news[i][..., :h] for i in (k - 1, k)]
            return torch.cat(emits, dim=-1)[..., -n:]

        stat, tstat = buffer(news_r), buffer(news_t)
        e = torch.cat([stat[..., :j], stat[..., j + 1:]], dim=-1)  # sample J left out
        kk = n - j
        d = tstat[..., -kk:].reshape(2, m * kk)
        r_mats, r_vecs = [], []
        for p in range(4):
            y = e[p].unfold(-1, j, 1).flip(-1)  # (M, S, K, J): y[.., c, i] = e[J - 1 + c - i]
            y = y.permute(1, 3, 0, 2).reshape(s * j, m * kk)
            r_mats.append(y @ y.T)
            if p in (0, 3):
                r_vecs.append(y @ d[p // 3])
        a = torch.stack([r_mats[0], r_mats[3]])
        b = torch.stack([r_mats[1], r_mats[2]])
        diag = torch.diagonal(b, dim1=-2, dim2=-1).mean(-1)
        eye = torch.eye(s * j, dtype=F64, device=b.device)
        b = b + (sem.reg_b_relative * diag + sem.reg_b)[:, None, None] * eye
        out.append(dict(a=a, b=b, r=torch.stack(r_vecs), stat=stat, tstat=tstat))
    return out


def span_filter(sem: Semantics, u: torch.Tensor, pencil: dict) -> torch.Tensor:
    """The span-V filter of each zone from V generalized eigenvectors ``u``
    (2, JL, V) that a solver returned B-normalized (u^T B u = 1), on this
    reference's pencil: w = sum_i (u_i . r) u_i / (u_i^T A u_i + mu), the
    eigenvalue of each vector taken as its Rayleigh quotient on A. Returns
    (2, S, J)."""
    ua = (u * (pencil["a"] @ u)).sum(-2)
    coef = (u * pencil["r"][..., None]).sum(-2) / (ua + sem.mu)
    w = (u * coef[:, None, :]).sum(-1)
    return w.reshape(2, sem.num_srcs, sem.filter_length)


def rayleigh(u: torch.Tensor, pencil: dict) -> torch.Tensor:
    """(2, V): u_i^T A u_i / u_i^T B u_i on this reference's pencil."""
    return (u * (pencil["a"] @ u)).sum(-2) / (u * (pencil["b"] @ u)).sum(-2)


def exact_top(sem: Semantics, pencil: dict, v: int | None = None):
    """The exact top-V generalized eigenpairs of each zone's pencil:
    (values (2, V) descending, vectors (2, JL, V) with u^T B u = 1)."""
    v = v or sem.num_eigenvectors
    chol = torch.linalg.cholesky(pencil["b"])
    half = torch.linalg.solve_triangular(chol, pencil["a"], upper=False)
    white = torch.linalg.solve_triangular(chol, half.transpose(-1, -2), upper=False)
    white = 0.5 * (white + white.transpose(-1, -2))
    vals, vecs = torch.linalg.eigh(white)
    vals, vecs = vals.flip(-1)[..., :v], vecs.flip(-1)[..., :v]
    u = torch.linalg.solve_triangular(chol.transpose(-1, -2), vecs, upper=True)
    return vals, u


def feeds(sem: Semantics, tables: Tables, segment: torch.Tensor, filters_prev: torch.Tensor,
          filters_cur: torch.Tensor) -> torch.Tensor:
    """The loudspeaker feeds of hop t, (2, hop, S) by zone: the input
    blocks of hops t - 1 and t (the last 2 hop samples through each),
    windowed, circularly filtered by that hop's (2, S, J) filters,
    windowed again and overlap-added."""
    h, block, L = sem.hop, sem.block_size, sem.rir_length
    x = segment[:, L - 1:]  # samples (t - 4) hop ... (t + 1) hop
    win = tables.window
    new = []
    # The block of hop tau starts (tau - t + 3) hops into x.
    for k, filt in ((2, filters_prev), (3, filters_cur)):  # blocks of hops t - 1, t
        xw = win * x[:, k * h: k * h + block]  # (2, block)
        spec = torch.fft.rfft(xw)[:, None, :] * torch.fft.rfft(filt, n=block)
        new.append(win * torch.fft.irfft(spec, n=block))  # (2, S, block)
    return (new[0][..., h:] + new[1][..., :h]).transpose(-1, -2)


def inverse_cholesky(pencil: dict) -> torch.Tensor:
    """(2, JL, JL): the inverse of the lower Cholesky factor of each zone's
    loaded dark matrix, the tracker's preconditioner from a rebuild hop."""
    chol = torch.linalg.cholesky(pencil["b"])
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    return torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)


def _orthonormal(y: torch.Tensor) -> torch.Tensor:
    """The columns of ``y`` orthonormalized in their order (the span and
    column order of CholeskyQR and of Gram-Schmidt)."""
    q, r = torch.linalg.qr(y)
    return q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]


def tracking_step(pencil: dict, q: torch.Tensor, lam: torch.Tensor, li: torch.Tensor,
                  jitter_rel: float, sweeps: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """One outer step of the top-k subspace tracker on this hop's pencil,
    from the incoming Ritz basis ``q`` (2, JL, k) and values ``lam`` (2, k):
    the block residual R = A X - B X L, preconditioned P = Li^T Li R with
    columns scaled to unit norm, Rayleigh-Ritz on the raw basis [X, P]
    (its Gram matrix on B loaded by ``jitter_rel`` times its mean
    diagonal, the precision's jitter), whitened by that matrix's Cholesky
    factor, two k-block power steps seeded from the X coordinates, and the
    k x k eigenproblem solved by ``sweeps`` Jacobi sweeps
    (:mod:`reference.jacobi`), or exactly for None. Returns the new Ritz
    vectors (2, JL, k), B-orthonormal, and values (2, k), descending."""
    a, b = pencil["a"], pencil["b"]
    k = q.shape[-1]
    aq, bq = a @ q, b @ q
    p = li.transpose(-1, -2) @ (li @ (aq - bq * lam[:, None, :]))
    p = p / torch.linalg.vector_norm(p, dim=-2, keepdim=True)
    s = torch.cat([q, p], dim=-1)
    st = s.transpose(-1, -2)
    abar = st @ torch.cat([aq, a @ p], dim=-1)
    bbar = st @ torch.cat([bq, b @ p], dim=-1)
    abar, bbar = 0.5 * (abar + abar.transpose(-1, -2)), 0.5 * (bbar + bbar.transpose(-1, -2))
    kk = bbar.shape[-1]
    eye = torch.eye(kk, dtype=bbar.dtype, device=bbar.device)
    tr = torch.diagonal(bbar, dim1=-2, dim2=-1).sum(-1) / kk
    lbar = torch.linalg.cholesky(bbar + (jitter_rel * tr)[:, None, None] * eye)
    libar = torch.linalg.solve_triangular(lbar, eye.expand_as(lbar), upper=False)
    wbar = libar @ abar @ libar.transpose(-1, -2)
    wbar = 0.5 * (wbar + wbar.transpose(-1, -2))
    y = _orthonormal(lbar.transpose(-1, -2)[..., :k])
    for _ in range(2):
        y = _orthonormal(wbar @ y)
    h = y.transpose(-1, -2) @ wbar @ y
    h = 0.5 * (h + h.transpose(-1, -2))
    d, v = torch.linalg.eigh(h) if sweeps is None else jacobi_eigh(h, sweeps)  # ascending
    return s @ (libar.transpose(-1, -2) @ (y @ v.flip(-1))), d.flip(-1)

