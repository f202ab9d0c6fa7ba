"""The timed drive of the program: one cell's model built from its inputs,
warmed up, then hops back to back in a closed loop for ``--seconds``.

Each hop hands in every stream's two program blocks from host memory,
replays the graphed hop, and brings the played span's loudspeaker feeds
(span V, ``StreamHost``'s default) and the silenced counts back to host
memory; its time on the host clock runs from handing in the inputs to the
feeds being there. The states that the judged hops and the hops before
them leave (the tracker's Ritz bases and values) are copied on the device
behind those hops, the judged hops' feeds kept, and every hop's rebuild
flag, for :mod:`harness.judge` once the window has closed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

from harness.scene import programs, scene_rirs, sub_seed

WARM_HOPS = 8  # past the tracking solver's 6 warmup rebuilds, and two plain hops
PROFILE_HOPS = 64  # two rebuild periods of the production solver
JUDGED_PAIRS = 6  # hops judged: one rebuild hop and five drawn from the seed

# The program's configuration fields that the configuration file's
# "scene" group sets.
SCENE_FIELDS = (
    "block_size", "filter_length", "modeling_delay", "reference_index_a",
    "reference_index_b", "num_eigenvectors", "mu", "statistics_buffer_length",
    "sampling_rate", "perceptual", "dtype",
)


@dataclasses.dataclass
class Built:
    model: object
    progs: torch.Tensor  # (N, 2, program_hops * hop), host
    rirs: list  # per scene (rir_a, rir_b)
    hop: int
    num_v: int
    batched: bool
    setup: dict = dataclasses.field(default_factory=dict)  # seconds of its parts


def check_semantics(program_config, config: dict) -> None:
    """Raise unless the program runs what the reference computes: the
    configuration file's ``reference`` group against the program's
    settings (read, not derived)."""
    ref = config["reference"]
    got = {
        "reg_b": program_config.reg_b,
        "reg_b_relative": program_config.effective_reg_b_relative,
        "pressure_scale_db_spl": program_config.pressure_scale_db_spl,
        "threshold_method": program_config.threshold_method.name.lower(),
        "weighting_norm": program_config.weighting_norm.name.lower(),
        "target_filter": program_config.target_filter.name.lower(),
        "toeplitz": program_config.toeplitz_variant.name.lower(),
        "regularization": program_config.regularization.name.lower(),
        "hop": program_config.hop,
        "tracking_outer_steps": program_config.tracking_outer_steps,
        "tracking_rr_basis": program_config.tracking_rr_basis,
        "small_eigh": program_config.small_eigh,
        "jacobi_sweeps": program_config.jacobi_sweeps,
    }
    want = {k: ref.get(k, v) for k, v in got.items()}
    want["hop"] = program_config.block_size // 2
    want["regularization"] = "python"
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    if bad:
        raise ValueError(f"the program's settings differ from the reference's: {bad}")


def build(cell, seed: int, device: torch.device, graph: bool) -> Built:
    """The cell's model (``ApVast`` for one stream, ``MultiSceneApVast``
    for several) under ``production_overrides()``, its scenes' responses
    and its streams' programs, all from ``seed``."""
    from apvast_torch import ApVast, ApVastConfig, MultiSceneApVast, production_overrides

    t0 = time.perf_counter()
    cfg_file, n = cell.config, cell.streams
    if cfg_file["overrides"] != "production_overrides":
        raise ValueError(f"unknown overrides {cfg_file['overrides']!r}")
    scene = cfg_file["scene"]
    fields = {k: scene[k] for k in SCENE_FIELDS}
    pairs = scene_rirs(dict(cfg_file, streams=n))
    gens = [torch.Generator().manual_seed(sub_seed(seed, 3, i)) for i in range(n)]
    overrides = production_overrides()
    if overrides.get("dtype", fields["dtype"]) != fields["dtype"]:
        raise ValueError(f"production_overrides() runs {overrides['dtype']}, the "
                         f"configuration states {fields['dtype']}")
    fields.pop("dtype")
    if n == 1:
        ra, rb = pairs[0]
        model = ApVast(
            fields["block_size"], ra, rb, fields["filter_length"], fields["modeling_delay"],
            fields["reference_index_a"], fields["reference_index_b"],
            fields["num_eigenvectors"], fields["mu"], fields["statistics_buffer_length"],
            sampling_rate=fields["sampling_rate"], perceptual=fields["perceptual"],
            device=device, generator=gens[0], graph=graph, **overrides,
        )
    else:
        config = ApVastConfig.for_rirs(*pairs[0], **fields, **overrides)
        model = MultiSceneApVast(config, pairs, device=device, generators=gens, graph=graph)
    check_semantics(model.config, cfg_file)
    hop = model.config.hop
    t_model = time.perf_counter()
    progs = programs(cell.traffic, seed, n, hop, device)
    built = Built(model, progs, pairs, hop, model.config.num_eigenvectors, n > 1)
    built.setup = dict(model_s=t_model - t0, programs_s=time.perf_counter() - t_model)
    return built


def judged_hops(seed: int, span: int) -> list[int]:
    """The hops judged, as stream hop indices past the warmup: a rebuild
    hop of the 32-hop cadence and others drawn from ``seed`` within the
    first ``span`` hops of the window; each is judged with the hop before
    it."""
    rng = np.random.default_rng(sub_seed(seed, 4))
    lo, hi = WARM_HOPS + 2, WARM_HOPS + span
    rebuild = 32 * int(rng.integers(1, max(2, hi // 32)))
    picks = {rebuild}
    while len(picks) < JUDGED_PAIRS:
        picks.add(int(rng.integers(lo, hi)))
    return sorted(picks)


class Loop:
    """Hands hops to the model and fetches what a hop returns."""

    def __init__(self, built: Built, device: torch.device):
        self.b = built
        self.n = built.progs.shape[0]
        cuda = device.type == "cuda"
        s = built.model.config.num_srcs
        self.feeds = torch.empty((self.n, 2, built.hop, s), dtype=torch.float32, pin_memory=cuda)
        self.silenced = torch.zeros((self.n,), dtype=torch.int32, pin_memory=cuda)
        self.prev_silenced = np.zeros(self.n, dtype=np.int64)
        self.event = torch.cuda.Event() if cuda else None
        self.host = built.progs.numpy()
        self.period = built.progs.shape[-1]

    def inputs(self, tau: int):
        off = (tau * self.b.hop) % self.period
        rows = slice(off, off + self.b.hop)
        if self.b.batched:
            return self.host[:, 0, rows], self.host[:, 1, rows]
        return self.host[0, 0, rows], self.host[0, 1, rows]

    def hop(self, tau: int, span=contextlib.nullcontext):
        """One hop; returns its rebuilt flag."""
        model = self.b.model
        a, b = self.inputs(tau)
        with span("bench.process_input_buffers"):
            if self.b.batched:
                out = model.process_input_buffers(a, b)
                out_a, out_b, rebuilt = out.out_a, out.out_b, bool(out.rebuilt)
            else:
                before = model.rebuilds
                out_a, out_b, _, _ = model.process_input_buffers(a, b)
                out_a, out_b, rebuilt = out_a[None], out_b[None], model.rebuilds != before
            self.out = (out_a, out_b)  # (N, V, hop, S) each
            fa, fb = out_a[:, -1], out_b[:, -1]
        with span("bench.fetch_feeds"):
            self.feeds.copy_(torch.stack([fa, fb], dim=1), non_blocking=True)
            self.silenced.copy_(model.silenced.reshape(-1), non_blocking=True)
            if self.event is not None:
                self.event.record()
                self.event.synchronize()
        return rebuilt

    def failed(self) -> int:
        """Streams of the last hop that silenced a solver output or whose
        feeds are not finite."""
        cum = self.silenced.numpy().astype(np.int64)
        bad = (cum - self.prev_silenced) > 0
        self.prev_silenced = cum
        finite = np.isfinite(self.feeds.numpy().reshape(self.n, -1).sum(-1))
        return int(np.count_nonzero(bad | ~finite))

    def snapshot(self, judged: bool) -> dict:
        """What the last hop left, copied on the device behind it: the
        tracker's Ritz basis (N, 2, JL, k) and values (N, 2, k), descending;
        for a judged hop also its weighted statistics buffers (N, 4, M, S,
        buffer - 1) and (N, 2, M, buffer) and its rank-1 feeds (N, 2, hop,
        S)."""
        st = self.b.model.state
        one = (lambda x: x) if self.b.batched else (lambda x: x[None])
        snap = dict(q=one(st.gevd_q.clone()), lam=one(st.gevd_lam.clone()))
        if judged:
            snap.update(stat=one(st.wresp_stat.clone()), tstat=one(st.wtarget_stat.clone()),
                        rank1=torch.stack([self.out[0][:, 0], self.out[1][:, 0]], dim=1))
        return snap


def run(built: Built, device: torch.device, seconds: float, trace: bool, judged: list[int],
        t_process: float) -> dict:
    """Warm up, then the window. Returns the run's record (see
    ``benchmark/metrics``)."""
    loop = Loop(built, device)
    tau = 0
    warm_rebuilt = []
    t_warm = time.perf_counter()
    for i in range(WARM_HOPS):
        # A traced run loads the profiler here, on its last warm hop: its
        # first start can take seconds, which the window must not hold.
        with _profiler() if trace and i == WARM_HOPS - 1 else contextlib.nullcontext():
            warm_rebuilt.append(loop.hop(tau))
        loop.failed()
        tau += 1
    want = set(judged) | {t - 1 for t in judged}
    snaps, kept = {}, {}
    hop_s, rebuilt, profiled = [], [], []
    attempted = failed = 0
    prof = None
    prof_hops = 0
    prof_t0 = prof_t1 = None
    setup_s = time.perf_counter() - t_process
    built.setup["warm_s"] = time.perf_counter() - t_warm
    t_start = time.perf_counter()
    t_end = t_start
    while True:
        now = time.perf_counter()
        # A traced window stays open until its profiled slice is whole.
        if now - t_start >= seconds and (not trace or prof_hops == PROFILE_HOPS):
            break
        in_prof = prof is not None and prof_hops < PROFILE_HOPS
        if trace and prof is None and now - t_start >= seconds / 2:
            prof = _profiler()
            prof.start()
            in_prof = True
        span = torch.profiler.record_function if in_prof else contextlib.nullcontext
        t0 = time.perf_counter()
        if in_prof and prof_t0 is None:
            prof_t0 = t0
        flag = loop.hop(tau, span)
        t1 = time.perf_counter()
        t_end = t1
        hop_s.append(t1 - t0)
        rebuilt.append(flag)
        profiled.append(in_prof)
        if in_prof:
            prof_hops += 1
            if prof_hops == PROFILE_HOPS:
                prof_t1 = t1
                prof.stop()
        attempted += loop.n
        failed += loop.failed()
        if tau in want:
            snaps[tau] = loop.snapshot(tau in judged)
            if tau in judged:
                kept[tau] = loop.feeds.numpy().copy()
        tau += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(
        setup_s=setup_s, window_s=t_end - t_start, hop_s=hop_s, rebuilt=rebuilt,
        rebuilt_tau=warm_rebuilt + rebuilt,
        profiled=profiled, attempted=attempted, failed=failed, hops=tau - WARM_HOPS,
        streams=loop.n, hop=built.hop, snaps=snaps, feeds=kept, prof=prof,
        prof_hops=prof_hops, prof_window_s=(prof_t1 - prof_t0) if prof_t0 else None,
        setup_parts=dict(built.setup),
    )


def _profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by the nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
