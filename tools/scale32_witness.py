"""Readings behind two bars of tests/test_torch_scale32.py, on the CPU:

    python3 tools/scale32_witness.py            # both
    python3 tools/scale32_witness.py float64    # the float64 parity bar
    python3 tools/scale32_witness.py deep       # the production feeds at JL = 800

**float64.** Why the float64 parity of the 32-speaker scene reads ~4e-9 on
its hops 2-3 and at most ~3e-10 on the others: the rounding of the
tracking solver's triangular inverses, which those hops amplify; not that
of its small eigensolve.

The stream is ``test_float64_tracking_parity``'s in
tests/test_torch_scale32.py (``scale_scene(32)`` with its depth cut to JL =
128, float64, ``small_eigh="lapack"``, full-form statistics, one outer
step, both programs +20 dB from hop 7 on; CPU). For each hop it prints,
relative to the hop's scale, the largest of the four output fields:

- ``port-jax``: the port against the JAX engine (the test's reading);
- ``trtri-Li`` and ``trtri-RR``: the port against itself, on the same
  inputs, with one triangular inverse of the tracking solver taken by
  LAPACK's ``dtrtri`` in place of the port's ``triangular_inverse``: the
  rebuild's inverse Cholesky factor Li of the (JL, JL) dark matrix, or the
  inverse of the Cholesky factor of the Rayleigh-Ritz Gram matrix (the
  whitening of the small pencil);
- ``evr``: the same with the (k, k) eigensolve taken by LAPACK's
  ``dsyevr`` (``scipy.linalg.eigh``, driver ``evr``) in place of
  ``torch.linalg.eigh``;

and ``cond(bbar)``, the condition number of that Gram matrix ``S^T B S``
on the production path's raw basis ``S = [X, P]`` (``rr_basis="direct"``:
not orthonormalized, whitened by the Gram matrix's own Cholesky factor)
in each zone (A, B).

On hops 2-3 a change of rounding in either triangular inverse alone
moves the port by half the distance between the two packages; a change in
the eigensolve moves it by a twentieth of it.

**deep.** ``test_production_against_jax``'s stream at JL = 800 (float32,
``production_overrides("tpu")``, the port from the JAX state carried
across before every hop): per hop, the port's loudspeaker feeds against
JAX's, and the JAX hop's own spread (``_Scene32.jax_spread``: its feeds'
largest move when the statistics it is handed change by 1e-7 relative,
over three draws), each in absolute terms and over the stream's scale.
"""

from __future__ import annotations

import importlib
import os
import sys

import jax
import numpy as np
import scipy.linalg
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from apvast_torch import production_overrides as port_production_overrides  # noqa: E402
from apvast_tpu.config import production_overrides  # noqa: E402
from test_torch_scale32 import (  # noqa: E402
    CUT,
    DEEP,
    FIELDS,
    FLOAT64,
    JAX_CONV,
    PARITY_HOPS,
    STEP_HOP,
    _rel,
    _Scene32,
)

jdiag = importlib.import_module("apvast_torch.ops.jdiag")  # the module, not its function
ORIGINAL = {name: getattr(jdiag, name) for name in ("cholesky", "triangular_inverse",
                                                    "_small_eigh")}


def _lapack_trtri_at(call):
    """``triangular_inverse`` by LAPACK's ``dtrtri`` at the hop's ``call``-th
    call only (0-based; the port's own at the others)."""
    calls = []

    def trtri(lower):
        calls.append(None)
        if len(calls) - 1 != call:
            return ORIGINAL["triangular_inverse"](lower)
        return torch.from_numpy(np.stack([scipy.linalg.lapack.dtrtri(m, lower=1)[0]
                                          for m in lower.numpy()]))
    return trtri


def _lapack_evr(h, small_eigh, jacobi_sweeps):
    pairs = [scipy.linalg.eigh(m, driver="evr") for m in h.numpy()]
    return (torch.from_numpy(np.stack([d for d, _ in pairs])),
            torch.from_numpy(np.stack([v for _, v in pairs])))


def _step(scene, a, b, **patches):
    for name, fn in patches.items():
        setattr(jdiag, name, fn)
    try:
        got, want, _, _ = scene.step(a, b)
    finally:
        for name, fn in ORIGINAL.items():
            setattr(jdiag, name, fn)
    return got, want


def float64_parity() -> None:
    overrides = production_overrides("tpu") | FLOAT64
    ref, trtri_li, trtri_rr, evr = (_Scene32(overrides, {}, CUT) for _ in range(4))
    two_k = 2 * ref.state.gevd_q.shape[-1]
    factored = []

    def recording_cholesky(x):
        factored.append(x.numpy().copy())
        return ORIGINAL["cholesky"](x)

    print("hop  port-jax  trtri-Li  trtri-RR  evr       cond(bbar) by zone")
    for h in range(PARITY_HOPS):
        gain = 10.0 if h >= STEP_HOP else 1.0
        a, b = ref.inputs(gain)
        for other in (trtri_li, trtri_rr, evr):
            other.inputs(gain)  # the same draws, to keep the streams in step
        # The warmup hops rebuild Li: its inverse is the hop's first.
        rebuild = h < ref.tc.tracking_warmup_hops
        factored.clear()
        got, want = _step(ref, a, b, cholesky=recording_cholesky)
        # One outer step: the Gram matrix is the last (2k, 2k) factorization
        # (the inner CholeskyQR2's are (k, k)).
        cond = [np.linalg.cond(m) for m in [f for f in factored if f.shape[-1] == two_k][-1]]
        got_li = (_step(trtri_li, a, b, triangular_inverse=_lapack_trtri_at(0))[0]
                  if rebuild else _step(trtri_li, a, b)[0])
        got_rr, _ = _step(trtri_rr, a, b, triangular_inverse=_lapack_trtri_at(int(rebuild)))
        got_evr, _ = _step(evr, a, b, _small_eigh=_lapack_evr)
        print(f"{h + 1:3d}  " + "  ".join(
            f"{x:.2e}" for x in (max(map(_rel, got, want)), max(map(_rel, got_li, got)),
                                 max(map(_rel, got_rr, got)), max(map(_rel, got_evr, got)),
                                 *cond)))


def deep_feeds() -> None:
    pair = _Scene32(production_overrides("tpu") | JAX_CONV, port_production_overrides(), DEEP)
    rows = []
    for _ in range(pair.tc.tracking_warmup_hops + 1):
        a, b = pair.inputs()
        spread = pair.jax_spread(pair.jstate, a, b)
        got, want, _, _ = pair.step(a, b, carry_jax_state=True)
        rows.append([(np.abs(got[f] - want[f]).max(), spread[f], np.abs(want[f]).max())
                     for f in range(2)])
    scales = np.max([[r[f][2] for f in range(2)] for r in rows], axis=0)
    print(f"JL = {pair.tc.jl}: stream scale {' '.join(f'{x:.3e}' for x in scales)} "
          f"({', '.join(FIELDS[:2])})")
    print("hop  field  port-jax (of scale)     jax spread (of scale)")
    for h, row in enumerate(rows):
        for f, (err, spread, _) in enumerate(row):
            print(f"{h + 1:3d}  {FIELDS[f]:5s}  {err:.3e} ({err / scales[f]:.3e})  "
                  f"{spread:.3e} ({spread / scales[f]:.3e})")


def main() -> None:
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py sets it
    torch.set_num_threads(1)
    which = sys.argv[1:] or ["float64", "deep"]
    if "float64" in which:
        float64_parity()
    if "deep" in which:
        deep_feeds()


if __name__ == "__main__":
    main()
