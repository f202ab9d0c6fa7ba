"""How far rounding alone moves the first (cold) hop of the card tests'
small scene, and the rule that tests/test_torch_cuda.py's
``test_production_hop_on_the_card_matches_cpu`` holds that hop to: the
card's loudspeaker feeds against the CPU hop with exact statistics
kernels (the float64 reference), within max(cold bar, 2 x d), the cold bar
max(5e-2, 4 x the spread printed here) and d the CPU float32 hop's own
distance from the reference.

    python3 tools/cold_hop_rounding.py            # the CPU alone
    python3 tools/cold_hop_rounding.py --card     # the card against the CPU

The scene is ``_s8_kwargs`` of tests/test_torch_cuda.py (S = 8, block 128,
J = 12, seeded), under each configuration of its ``_CARD_PATHS``. On the
CPU, for 8 hops of each configuration, it prints:

- each hop's largest loudspeaker feed sample (hop 1 is the cold one: the
  statistics hold only the initial noise);
- d: hop 1's feeds with the statistics kernels (K1, K2, K3 and K6) exact,
  their plain versions computed in float64 and rounded once to float32
  (the test's ``exact_hop``), against the float32 run, relative to hop
  1's own scale;
- hop 1's spread under 1e-7 relative changes of the initial noise (3
  draws), relative to its own scale, and the bar the test derives.

With ``--card``, instead: each card hop against the CPU hop from the
card's state, as the test compares them (relative to the hop's own
scale), three times: with the statistics kernels as shipped, with their
plain versions in float32 on the card (cuBLAS, TF32 off) and with them
exact. The last two show how far the card's other operations alone carry
the hop. Then, with the kernels as shipped, hop 1 under the test's rule:
the reading against the float64 reference beside d and the bar; and hop
1 against that reference with one statistics kernel at a time exact and
the others as shipped, which names the kernel that carries the card's
hop furthest from it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from apvast_torch import ApVast, production_overrides  # noqa: E402
from apvast_torch.engine import process_hop  # noqa: E402
from apvast_torch.ops import kernels as K  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    _CARD_PATHS,
    COLD_SPREAD_FACTOR,
    COLD_SPREAD_SEEDS,
    EXACT_KERNELS,
    TOL_ORACLE_RATIO,
    _rel,
    _s8_kwargs,
    _state_to,
    exact_hop,
    statistics_kernels,
)

FEEDS = ("out_a", "out_b")
PLAIN_KERNELS = {"streaming_conv": K.streaming_conv_plain, "covariance": K.covariance_plain,
                 "lag_corr": K.lag_corr_plain, "lag_skew_assemble": K.lag_skew_assemble_plain}


def _scene(overrides, jitter_seed=None):
    rng = np.random.default_rng(10)
    kwargs = _s8_kwargs(rng, production_overrides() | overrides)
    if jitter_seed is not None:
        jr = np.random.default_rng(jitter_seed)
        kwargs["response_noise"] = tuple(
            x * (1 + 1e-7 * jr.standard_normal(x.shape)) for x in kwargs["response_noise"])
    return kwargs, rng.standard_normal((8, 2, 64)).astype(np.float32)


def _run(overrides, jitter_seed=None):
    """8 hops of the scene on the CPU: the feeds of each hop."""
    kwargs, hops = _scene(overrides, jitter_seed)
    model = ApVast(device="cpu", **kwargs)
    return [model.process_input_buffers(a, b)[:2] for a, b in hops]


def _d(overrides) -> float:
    """The CPU float32 hop 1's distance from its float64 reference."""
    kwargs, hops = _scene(overrides)
    model = ApVast(device="cpu", **kwargs)
    start = model.state
    want = model.process_input_buffers(*hops[0])[:2]
    ref = exact_hop(model.config, model.plan, start, *hops[0])
    return max(_rel(w, getattr(ref, name)) for w, name in zip(want, FEEDS))


def _cpu_plan(kwargs):
    model = ApVast(device="cpu", **kwargs)
    return model.config, model.plan, model.state


def cpu_report() -> None:
    for config, (overrides, _) in _CARD_PATHS.items():
        base = _run(overrides)
        print(f"{config}: largest feed sample per hop "
              f"{[f'{max(float(x.abs().max()) for x in hop):.2e}' for hop in base]}")
        d = _d(overrides)
        print(f"{config}: hop 1, float32 against exact kernels (d): {d:.2e} of its scale")
        spread = [max(_rel(x, y) for x, y in zip(_run(overrides, jitter_seed=s)[0], base[0]))
                  for s in COLD_SPREAD_SEEDS]
        cold = max(5e-2, COLD_SPREAD_FACTOR * max(spread))
        print(f"{config}: hop 1 under 1e-7 changes of the initial noise: "
              f"{[f'{x:.2e}' for x in spread]} of its scale; cold bar {cold:.3e}, bar "
              f"max(cold bar, {TOL_ORACLE_RATIO} x d) = {max(cold, TOL_ORACLE_RATIO * d):.3e}",
              flush=True)


def card_report(dev: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    forms = {"kernels": {}, "plain": PLAIN_KERNELS, "exact": EXACT_KERNELS}
    for config, (overrides, _) in _CARD_PATHS.items():
        for form, chosen in forms.items():
            kwargs, hops = _scene(overrides)
            card, cpu = ApVast(device=dev, **kwargs), ApVast(device="cpu", **kwargs)
            own = []
            for i, (a, b) in enumerate(hops):
                start = _state_to(card.state, "cpu")
                with statistics_kernels(chosen):
                    got = card.process_input_buffers(a, b)[:2]
                # The CPU hop: plain.
                cpu.state, out = process_hop(cpu.config, cpu.plan, start,
                                             torch.from_numpy(a), torch.from_numpy(b))
                own.append([_rel(g, getattr(out, name)) for g, name in zip(got, FEEDS)])
                if form == "kernels" and i == 0:
                    ref = exact_hop(cpu.config, cpu.plan, start, a, b)
                    d = max(_rel(getattr(out, name), getattr(ref, name)) for name in FEEDS)
                    reading = max(_rel(g, getattr(ref, name)) for g, name in zip(got, FEEDS))
                    spread = max(max(_rel(x, y) for x, y in zip(
                        _run(overrides, jitter_seed=s)[0], _run(overrides)[0]))
                        for s in COLD_SPREAD_SEEDS)
                    cold = max(5e-2, COLD_SPREAD_FACTOR * spread)
                    bar = max(cold, TOL_ORACLE_RATIO * d)
                    print(f"card {config}, hop 1 against the float64 reference: {reading:.3e} "
                          f"(d {d:.3e}, cold bar {cold:.3e}, bar {bar:.3e}: "
                          f"{'holds' if reading <= bar else 'FAILS'})", flush=True)
            print(f"card {config}, statistics kernels {form}: per hop, own scale (out_a, out_b) "
                  f"{[f'{x:.1e}/{y:.1e}' for x, y in own]}", flush=True)
        kwargs, hops = _scene(overrides)
        ref = exact_hop(*_cpu_plan(kwargs), *hops[0])
        for name, fn in EXACT_KERNELS.items():
            card = ApVast(device=dev, **kwargs)
            with statistics_kernels({name: fn}):
                got = card.process_input_buffers(*hops[0])[:2]
            reading = max(_rel(g, getattr(ref, n)) for g, n in zip(got, FEEDS))
            print(f"card {config}, hop 1 against the float64 reference with {name} exact, "
                  f"the others as shipped: {reading:.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card", action="store_true", help="also the card against the CPU")
    args = ap.parse_args()
    if not args.card:
        cpu_report()
    elif not torch.cuda.is_available():
        print("--card needs a CUDA card", file=sys.stderr)
        return 1
    else:
        card_report("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
