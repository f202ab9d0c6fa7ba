"""Which hops ``tracking_residual_precision="default"`` silences, in the
port and in the JAX engine, on the same scene, state and program.

The knob gives the tracking solver's residual-path products the TPU's
single pass: operands rounded to bfloat16, their exact products summed in
float32. JAX on the CPU computes ``Precision.DEFAULT`` in full float32, so
the JAX engine runs here under ``jax_single_pass`` of
tests/test_torch_matlab_variants.py, which rounds those products' operands
for the duration (the JAX package's files are not changed).

    python3 tools/residual_default_witness.py [--srcs 8] [--hops 40]   # the CPU
    python3 tools/residual_default_witness.py --card [--srcs 16] [--hops 64]

The scene is ``scale_scene(srcs)`` under ``production_overrides()`` with
the knob; the initial response noise and the program are chip_smoke.py's
(``_inputs``: its seed, 1e-3 noise, white float32 signals), the cold basis
the port's default (a ``torch.Generator`` seeded with 7), given to both
engines. On the CPU it runs, free running for ``--hops`` hops each:

- JAX, single pass: the JAX engine with rounded DEFAULT products;
- JAX, float32: the JAX engine as the CPU computes it (the control);
- port: the port on the CPU (plain versions of the kernels);
- port from JAX: each hop of the port from the single-pass JAX run's state
  (the JAX state carried across, as the tests do).

With ``--card`` (no JAX there) it runs the port alone on the card, eager,
every kernel launched, and under the knob each hop of the port on the CPU
from the card's state beside it (the silenced counts of both). For each run it prints the hops that silenced
(hop, count; one zone's count is JL * V + V) and the zone-A contrast at
rank 1 over hops 7 to the last; then the port's run with full-precision
residual products (``"high"``, the production value) beside them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from apvast_torch import production_overrides  # noqa: E402
from apvast_torch.engine import build_plan, init_state, process_hop  # noqa: E402
from apvast_torch.evaluation import acoustic_contrast_db, predict_pressure  # noqa: E402
from apvast_torch.utils.scenes import scale_scene  # noqa: E402

SEED = 20261016  # chip_smoke.py's
TAIL_FROM = 6  # contrast over hops 7 to the last


def _inputs(cfg, hops):
    """chip_smoke.py's ``_inputs`` at ``hops`` hops."""
    rng = np.random.default_rng(SEED)
    m, s, block = cfg.num_mics, cfg.num_srcs, cfg.block_size
    noise = (1e-3 * rng.standard_normal((4, m, s, block)),
             1e-3 * rng.standard_normal((2, m, block)))
    return noise, rng.standard_normal((2, hops * cfg.hop)).astype(np.float32)


def _report(label, scene, silenced, feeds_a, seconds):
    """The silenced hops and the zone-A rank-1 contrast of a run."""
    contrast = float("nan")
    if len(feeds_a) > TAIL_FROM:
        f = torch.cat([torch.as_tensor(np.array(x))[0] for x in feeds_a[TAIL_FROM:]]).double()
        contrast = float(acoustic_contrast_db(predict_pressure(f, scene.rir_a),
                                              predict_pressure(f, scene.rir_b)))
    nz = [(i + 1, int(n)) for i, n in enumerate(silenced) if n]
    print(f"{label}: {len(silenced)} hops, silenced on {len(nz)} {nz}; zone-A rank-1 contrast "
          f"over hops {TAIL_FROM + 1}-{len(silenced)} {contrast:.4f} dB ({seconds:.1f} s)",
          flush=True)


def _port_run(cfg, scene, noise, sig, device):
    """The port free running on ``device``; on the card under the knob also
    each hop of the port on the CPU from the card's state: the silenced
    counts of both, and the run's feeds."""
    plan = build_plan(cfg, scene.rir_a, scene.rir_b, device)
    cpu_plan = build_plan(cfg, scene.rir_a, scene.rir_b, "cpu")
    state = init_state(cfg, device, response_noise=noise)
    x = torch.from_numpy(sig)
    silenced, cpu_silenced, feeds = [], [], []
    for i in range(x.shape[1] // cfg.hop):
        a, b = x[0, i * cfg.hop:(i + 1) * cfg.hop], x[1, i * cfg.hop:(i + 1) * cfg.hop]
        if device != "cpu" and cfg.tracking_residual_precision == "default":
            cpu_state = dataclasses.replace(state, **{
                f.name: getattr(state, f.name).cpu() for f in dataclasses.fields(state)
                if isinstance(getattr(state, f.name), torch.Tensor)})
            _, out = process_hop(cfg, cpu_plan, cpu_state, a, b)
            cpu_silenced.append(int(out.silenced))
        state, out = process_hop(cfg, plan, state, a.to(device), b.to(device))
        silenced.append(int(out.silenced))
        feeds.append(out.out_a.cpu())
    return silenced, cpu_silenced, feeds


def _jax_runs(scene, noise, sig, precision, hops):
    """The JAX engine free running (single pass, then as the CPU computes
    it), and the port from the single-pass run's state hop by hop."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_matlab_variants import _arrays, jax_single_pass

    from apvast_torch.utils.convert import config_from_jax, state_from_numpy
    from apvast_tpu.config import production_overrides as jax_production_overrides
    from apvast_tpu.engine import build_plan as jax_build_plan
    from apvast_tpu.engine import init_state as jax_init_state
    from apvast_tpu.engine import process_hop as jax_process_hop
    from apvast_tpu.utils.scenes import scale_scene as jax_scale_scene

    jc = dataclasses.replace(jax_scale_scene(scene.config.num_srcs).config,
                             **jax_production_overrides("tpu"),
                             tracking_residual_precision=precision)
    tc = config_from_jax(dataclasses.asdict(jc))
    plan = build_plan(tc, scene.rir_a, scene.rir_b, "cpu")
    q0 = init_state(tc, "cpu", response_noise=noise).gevd_q.numpy()
    jplan = jax_build_plan(jc, scene.rir_a, scene.rir_b)
    hop = jc.hop

    def run(single_pass):
        jstate = dataclasses.replace(jax_init_state(jc, response_noise=noise),
                                     gevd_q=jnp.asarray(q0))
        step = jax.jit(lambda st, a, b: jax_process_hop(jc, jplan, st, a, b))
        silenced, feeds, port_silenced, port_feeds = [], [], [], []
        for i in range(hops):
            a, b = sig[0, i * hop:(i + 1) * hop], sig[1, i * hop:(i + 1) * hop]
            if single_pass:
                _, out = process_hop(tc, plan, state_from_numpy(tc, _arrays(jstate), "cpu"),
                                     torch.from_numpy(a), torch.from_numpy(b))
                port_silenced.append(int(out.silenced))
                port_feeds.append(out.out_a)
            jstate, jout = step(jstate, jnp.asarray(a), jnp.asarray(b))
            silenced.append(int(jout.silenced))
            feeds.append(np.asarray(jout.out_a))
        return silenced, feeds, port_silenced, port_feeds

    t = time.perf_counter()
    with jax_single_pass():
        silenced, feeds, port_silenced, port_feeds = run(True)
    seconds = time.perf_counter() - t
    _report(f"JAX, single pass, {precision}", scene, silenced, feeds, seconds)
    _report(f"port from JAX, {precision}", scene, port_silenced, port_feeds, seconds)
    t = time.perf_counter()
    silenced, feeds, _, _ = run(False)
    _report(f"JAX, float32, {precision}", scene, silenced, feeds, time.perf_counter() - t)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--srcs", type=int, default=8, help="scale_scene's loudspeakers")
    ap.add_argument("--hops", type=int, default=40)
    ap.add_argument("--card", action="store_true", help="the port alone, on the card")
    args = ap.parse_args()
    if args.card and not torch.cuda.is_available():
        print("--card: no card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = scale_scene(args.srcs)
    noise, sig = _inputs(scene.config, args.hops)
    device = "cuda" if args.card else "cpu"
    print(f"scale_scene({args.srcs}): JL={scene.config.jl}, V={scene.config.num_eigenvectors}, "
          f"one zone silenced = {scene.config.jl * scene.config.num_eigenvectors + scene.config.num_eigenvectors}"
          f"; {args.hops} hops; {device}", flush=True)
    if args.card:
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=False).stdout.strip(), flush=True)
    for precision in ("default", "high"):
        cfg = dataclasses.replace(scene.config, **production_overrides(),
                                  tracking_residual_precision=precision)
        t = time.perf_counter()
        silenced, cpu_silenced, feeds = _port_run(cfg, scene, noise, sig, device)
        _report(f"port ({device}), {precision}", scene, silenced, feeds, time.perf_counter() - t)
        if args.card and precision == "default":
            differ = [(i + 1, c, h) for i, (c, h) in enumerate(zip(silenced, cpu_silenced))
                      if c != h]
            print(f"port (cpu) from the card's state, {precision}: silenced on "
                  f"{sum(1 for n in cpu_silenced if n)} hops; hops where it differs from the "
                  f"card (hop, card, cpu): {differ}", flush=True)
        if not args.card and precision == "default":
            _jax_runs(scene, noise, sig, precision, args.hops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
