"""How far rounding alone moves the first (cold) hop of the card tests'
small scene: the hop at which tests/test_torch_cuda.py's
``test_production_hop_on_the_card_matches_cpu`` holds the card's
loudspeaker feeds to 5e-2 of the hop's own scale.

    python3 tools/cold_hop_rounding.py            # the CPU alone
    python3 tools/cold_hop_rounding.py --card     # the card against the CPU

The scene is ``_s8_kwargs`` of tests/test_torch_cuda.py (S = 8, block 128,
J = 12, seeded), under each configuration of its ``_CARD_PATHS``. On the
CPU, for 8 hops of each configuration, it prints:

- each hop's largest loudspeaker feed sample (hop 1 is the cold one: the
  statistics hold only the initial noise);
- hop 1's feeds with K1 and K6's plain versions computed in float64 and
  rounded once to float32 ("exact kernels"), against the float32 run,
  relative to hop 1's own scale;
- hop 1's spread under 1e-7 relative changes of the initial noise (3
  draws), relative to its own scale.

With ``--card``, instead: each card hop against the CPU hop from the card's state,
as the test compares them (relative to the hop's own scale), three times:
with K1 and K6 as shipped, with their plain versions in float32 on the card
(cuBLAS, TF32 off) and with them exact (float64, rounded once). The last
two show how far the card's other operations alone carry the hop.
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
from apvast_torch.engine import hop as HOP  # noqa: E402
from apvast_torch.engine import process_hop  # noqa: E402
from apvast_torch.ops import kernels as K  # noqa: E402
from test_torch_cuda import _CARD_PATHS, _rel, _s8_kwargs, _state_to  # noqa: E402

FEEDS = ("out_a", "out_b")


def _exact_conv(s, k, h):
    return K.streaming_conv_plain(s.double(), k.double(), h).float()


def _exact_cov(b, t, j):
    return tuple(x.float() for x in K.covariance_plain(b.double(), t.double(), j))


def _run(overrides, exact=False, jitter_seed=None):
    """8 hops of the scene on the CPU: the feeds of each hop."""
    shipped = HOP.streaming_conv, HOP.covariance
    if exact:
        HOP.streaming_conv, HOP.covariance = _exact_conv, _exact_cov
    try:
        rng = np.random.default_rng(10)
        kwargs = _s8_kwargs(rng, production_overrides() | overrides)
        if jitter_seed is not None:
            jr = np.random.default_rng(jitter_seed)
            kwargs["response_noise"] = tuple(
                x * (1 + 1e-7 * jr.standard_normal(x.shape)) for x in kwargs["response_noise"])
        model = ApVast(device="cpu", **kwargs)
        return [model.process_input_buffers(a, b)[:2]
                for a, b in rng.standard_normal((8, 2, 64)).astype(np.float32)]
    finally:
        HOP.streaming_conv, HOP.covariance = shipped


def cpu_report() -> None:
    for config, (overrides, _) in _CARD_PATHS.items():
        base = _run(overrides)
        print(f"{config}: largest feed sample per hop "
              f"{[f'{max(float(x.abs().max()) for x in hop):.2e}' for hop in base]}")
        exact = _run(overrides, exact=True)[0]
        print(f"{config}: hop 1, exact kernels against float32: "
              f"{max(_rel(x, y) for x, y in zip(exact, base[0])):.2e} of its scale")
        spread = [max(_rel(x, y) for x, y in zip(_run(overrides, jitter_seed=s)[0], base[0]))
                  for s in (101, 102, 103)]
        print(f"{config}: hop 1 under 1e-7 changes of the initial noise: "
              f"{[f'{x:.2e}' for x in spread]} of its scale", flush=True)


def card_report(dev: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shipped = HOP.streaming_conv, HOP.covariance
    forms = {"kernels": shipped, "plain": (K.streaming_conv_plain, K.covariance_plain),
             "exact": (_exact_conv, _exact_cov)}
    try:
        for config, (overrides, _) in _CARD_PATHS.items():
            for form, (conv, cov) in forms.items():
                HOP.streaming_conv, HOP.covariance = conv, cov
                rng = np.random.default_rng(10)
                kwargs = _s8_kwargs(rng, production_overrides() | overrides)
                card, cpu = ApVast(device=dev, **kwargs), ApVast(device="cpu", **kwargs)
                own = []
                for a, b in rng.standard_normal((8, 2, 64)).astype(np.float32):
                    start = _state_to(card.state, "cpu")
                    got = card.process_input_buffers(a, b)[:2]
                    HOP.streaming_conv, HOP.covariance = shipped  # the CPU hop: plain
                    cpu.state, out = process_hop(cpu.config, cpu.plan, start,
                                                 torch.from_numpy(a), torch.from_numpy(b))
                    HOP.streaming_conv, HOP.covariance = conv, cov
                    own.append([_rel(g, getattr(out, name)) for g, name in zip(got, FEEDS)])
                print(f"card {config}, K1 and K6 {form}: per hop, own scale (out_a, out_b) "
                      f"{[f'{x:.1e}/{y:.1e}' for x, y in own]}", flush=True)
    finally:
        HOP.streaming_conv, HOP.covariance = shipped


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
