#!/usr/bin/env python
"""End-to-end demo on the PyTorch port: the Matlab/main.m experiment.

Loads the bundled scene (its synthetic stand-in when ``rirs.mat`` is
absent), streams two program signals through the AP-VAST engine of
``apvast_torch`` in MATLAB multi-solution mode (spans [1, JL/2, JL] -
BACC / mid-span / pressure matching, Matlab/main.m:38), predicts the zone
pressures on held-out validation microphones, and prints contrast, NMSE
and detectability per span (metric definitions Matlab/main.m:120-130).
The counterpart of ``examples/run_demo.py``, with the same flags, fields
and table; it imports nothing of JAX.

It runs on the CUDA card unless ``--cpu`` is given, and without a card it
stops with an error instead of running on the CPU.

Usage:  python examples/run_demo_torch.py [--cpu] [--hops N] [--perceptual]
            [--x64] [--fd] [--fast] [--wav-a A.wav] [--wav-b B.wav]
            [--plot OUT.png]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# Allow running straight from a checkout.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain PyTorch versions)")
    parser.add_argument("--hops", type=int, default=20)  # main.m:47
    parser.add_argument("--perceptual", action="store_true")
    parser.add_argument("--x64", action="store_true", help="float64 parity mode")
    parser.add_argument("--fd", action="store_true", help="frequency-domain engine")
    parser.add_argument(
        "--fast", action="store_true",
        help="production stack: subspace GEVD + the CUDA kernels + matmul-DFT (float32)",
    )
    parser.add_argument("--wav-a", help="program A wav file (default: noise)")
    parser.add_argument("--wav-b", help="program B wav file (default: noise)")
    parser.add_argument(
        "--plot", metavar="OUT.png",
        help="save the main.m:78-118 four-panel pressure figure "
             "(target vs reproduced, mic 0, all spans)",
    )
    return parser.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Stream ``args.hops`` hops and evaluate every span. Returns the device,
    the wall seconds of the stream, the rows (span, contrast A dB, contrast
    B dB, NMSE A, NMSE B, detectability), and what ``--plot`` draws."""
    import numpy as np
    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run_demo_torch.py runs on the card; "
                           "pass --cpu to run it on the CPU")
    device = "cpu" if args.cpu else "cuda"

    from apvast_torch import ApVast, ApVastFD, GevdSolver
    from apvast_torch.evaluation import (
        acoustic_contrast_db,
        detectability,
        normalized_mse,
        predict_pressure,
    )
    from apvast_torch.perceptual.tables import build_perceptual_tables
    from apvast_torch.utils.rir import load_reference_rirs

    # Control RIRs = the bundled scene. The held-out validation set:
    # virtual microphones halfway between adjacent control microphones
    # (pairwise-averaged RIRs), positions that never enter the design.
    rir_a, rir_b = load_reference_rirs()
    val_a = 0.5 * (rir_a[:, :, :-1] + rir_a[:, :, 1:])
    val_b = 0.5 * (rir_b[:, :, :-1] + rir_b[:, :, 1:])

    filter_length, srcs = 100, rir_a.shape[1]
    common = dict(
        block_size=1600, rir_a=rir_a, rir_b=rir_b, filter_length=filter_length,
        modeling_delay=20, reference_index_a=7, reference_index_b=7, mu=1.0,
        sampling_rate=48000, perceptual=args.perceptual, device=device,
        generator=torch.Generator().manual_seed(0),
        dtype="float64" if args.x64 else "float32",
    )
    if args.fast:
        common.update(
            gevd_solver=GevdSolver.SUBSPACE, subspace_oversample=6, subspace_iters=2,
            use_pallas_statistics=True, use_pallas_output=True, use_pallas_conv=True,
            use_matmul_dft=True,
        )
    if args.fd:
        spans = (1, srcs // 2, srcs)  # per-bin ranks 1..num_srcs
        model = ApVastFD(number_of_eigenvectors=srcs, **common)
        span_index = {sp: sp - 1 for sp in spans}
    else:
        # Spans [1, JL/2, JL] in the reference (main.m:38); V = 200 keeps
        # the eigendecomposition affordable while spanning BACC ->
        # mid-span -> near pressure matching.
        spans = (1, 50, 200)
        model = ApVast(number_of_eigenvectors=max(spans), statistics_buffer_length=1000,
                       output_spans=spans, **common)
        span_index = {sp: i for i, sp in enumerate(spans)}

    rng = np.random.default_rng(7)
    hop = model.config.hop

    def program(path):
        if path:
            from apvast_torch.utils.io import load_wav

            sig, _ = load_wav(path, target_rate=48000)
            return sig[: hop * args.hops]
        return rng.standard_normal(hop * args.hops)

    sig_a, sig_b = program(args.wav_a), program(args.wav_b)

    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_a, out_b, out_a_t, out_b_t = model.process_signals(sig_a, sig_b)
    if device == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0

    tail = slice(hop * 6, None)  # drop the warmup
    target_a = predict_pressure(out_a_t[0][tail], val_a)
    target_b = predict_pressure(out_b_t[0][tail], val_b)
    tables = build_perceptual_tables(1600, 48000.0, 94.0)
    rows, pressures = [], {}
    for span in spans:
        i = span_index[span]
        fa, fb = out_a[i][tail], out_b[i][tail]
        p_aa, p_ab = predict_pressure(fa, val_a), predict_pressure(fa, val_b)
        p_bb, p_ba = predict_pressure(fb, val_b), predict_pressure(fb, val_a)
        pressures[span] = tuple(p.cpu().numpy() for p in (p_aa, p_ab, p_bb, p_ba))
        # Detectability of program-A leakage in zone B, masked by zone B's
        # own pressure (block 0, mic 0).
        d = detectability(p_ab[:1600, 0][None], p_bb[:1600, 0][None], tables).mean()
        rows.append((span, float(acoustic_contrast_db(p_aa, p_ab)),
                     float(acoustic_contrast_db(p_bb, p_ba)),
                     float(normalized_mse(p_aa, target_a)),
                     float(normalized_mse(p_bb, target_b)), float(d)))
    return dict(device=device, hops=args.hops, seconds=elapsed,
                audio_seconds=args.hops * hop / 48000, spans=spans, rows=rows,
                target_a=target_a.cpu().numpy(), target_b=target_b.cpu().numpy(),
                pressures=pressures)


def main(argv=None) -> int:
    args = parse_args(argv)
    result = run(args)
    print(f"streamed {result['hops']} hops ({result['audio_seconds']:.2f} s audio) "
          f"in {result['seconds']:.2f} s wall on {result['device']}")
    print(f"\n{'span':>6} {'contrA dB':>10} {'contrB dB':>10} "
          f"{'nmseA':>8} {'nmseB':>8} {'detect(leak A->B)':>18}")
    for span, ca, cb, na, nb, d in result["rows"]:
        print(f"{span:>6} {ca:>10.1f} {cb:>10.1f} {na:>8.3f} {nb:>8.3f} {d:>18.2e}")
    if args.plot:
        save_pressure_figure(args.plot, result["spans"], result["target_a"],
                             result["target_b"], result["pressures"])
        print(f"wrote {args.plot}")
    return 0


def save_pressure_figure(path, spans, target_a, target_b, pressures):
    """The Matlab/main.m:78-118 figure: four panels of target vs
    reproduced pressure at validation mic 0, one trace per span (legend
    'target', 'V = 1', 'V = JL/2', 'V = JL' in main.m). Panels: A to A and
    B to B (reproduction in the bright zone), B to A and A to B (leakage
    into the dark zone, against that zone's target for scale)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    n = min(2000, target_a.shape[0])
    t = np.arange(n) / 48.0  # ms
    # One data-driven limit for all four panels (main.m:78 pins [-0.5,
    # 0.5] for its scaled program material; the scene's pressures are
    # ~1e-3).
    lim = 1.15 * max(
        np.abs(target_a[:n, 0]).max(),
        np.abs(target_b[:n, 0]).max(),
        max(np.abs(p[:n, 0]).max() for ps in pressures.values() for p in ps),
    )
    series = ["#2a78d6", "#eb6834", "#1baf7a"]
    target_ink = "#555555"

    fig, axes = plt.subplots(2, 2, figsize=(11, 7), sharex=True, sharey=True)
    panels = [
        ("A to A", target_a, [pressures[s][0] for s in spans]),
        ("B to B", target_b, [pressures[s][2] for s in spans]),
        ("B to A (leakage)", target_a, [pressures[s][3] for s in spans]),
        ("A to B (leakage)", target_b, [pressures[s][1] for s in spans]),
    ]
    for ax, (title, target, traces) in zip(axes.ravel(), panels):
        ax.plot(t, target[:n, 0], color=target_ink, lw=1.6, ls="--", label="target", zorder=1)
        for c, span, p in zip(series, spans, traces):
            ax.plot(t, p[:n, 0], color=c, lw=1.0, label=f"V = {span}", zorder=2)
        ax.set_title(title, fontsize=11)
        ax.set_ylim(-lim, lim)
        ax.grid(True, color="#e3e2d9", lw=0.6)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
    axes[0, 0].legend(loc="upper right", fontsize=9, frameon=False)
    for ax in axes[1]:
        ax.set_xlabel("time (ms)")
    for ax in axes[:, 0]:
        ax.set_ylabel("pressure")
    fig.suptitle("AP-VAST reproduced vs target pressure (validation mic 0)")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


if __name__ == "__main__":
    sys.exit(main())
