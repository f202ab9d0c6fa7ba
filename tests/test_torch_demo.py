"""The port's demo, ``examples/run_demo_torch.py``, against the JAX
package's, ``examples/run_demo.py``, on the CPU.

Both stream 10 hops of the same seeded program signals through the
bundled scene's synthetic stand-in and print contrast, NMSE and
detectability per span. The JAX demo runs as the script it is (its own
process, float32, as a user runs it); its table is parsed and held against
the port's unrounded values: contrast within 0.1 dB and NMSE within 1%
relative, each beyond half of the JAX table's print step (0.05 dB, 0.0005),
which is all the printed value says of the number. The two draw their
initial response noise from different generators (JAX's ``jax.random``
key 0, the port's ``torch.Generator`` seeded 0); the table reads the hops
after the warmup, where that noise has left the statistics.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
HOPS = 10
MODES = {"default": (), "fd": ("--fd",)}
TOL_DB, TOL_NMSE = 0.1, 1e-2
HALF_STEP_DB, HALF_STEP_NMSE = 0.05, 5e-4


def _load_demo():
    spec = importlib.util.spec_from_file_location(
        "run_demo_torch", ROOT / "examples" / "run_demo_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_demos():
    """The JAX demo of every mode, started at once in processes of their
    own (they run while the port's demo runs here)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {
        mode: subprocess.Popen(
            [sys.executable, "examples/run_demo.py", "--cpu", "--hops", str(HOPS), *flags],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode, flags in MODES.items()
    }
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def _table(proc):
    """A JAX demo's table, {span: (contrA, contrB, nmseA, nmseB)}."""
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    rows = out.split("detect(leak A->B)", 1)[1].split("\n")
    return {int(r.split()[0]): tuple(float(x) for x in r.split()[1:5]) for r in rows if r.strip()}


@pytest.mark.parametrize("mode", list(MODES))
def test_demo_table_matches_jax(jax_demos, mode):
    demo = _load_demo()
    result = demo.run(demo.parse_args(["--cpu", "--hops", str(HOPS), *MODES[mode]]))
    assert result["device"] == "cpu"
    want = _table(jax_demos[mode])
    assert [row[0] for row in result["rows"]] == sorted(want)
    for span, ca, cb, na, nb, d in result["rows"]:
        wa, wb, wna, wnb = want[span]
        assert abs(ca - wa) <= TOL_DB + HALF_STEP_DB, (span, ca, wa)
        assert abs(cb - wb) <= TOL_DB + HALF_STEP_DB, (span, cb, wb)
        assert abs(na - wna) <= TOL_NMSE * wna + HALF_STEP_NMSE, (span, na, wna)
        assert abs(nb - wnb) <= TOL_NMSE * wnb + HALF_STEP_NMSE, (span, nb, wnb)
        assert np.isfinite(d) and d > 0


def test_save_pressure_figure_writes_png(tmp_path):
    demo = _load_demo()
    rng = np.random.default_rng(0)
    n, mics = 600, 3
    spans = (1, 4, 8)
    target_a = rng.standard_normal((n, mics))
    target_b = rng.standard_normal((n, mics))
    pressures = {
        s: tuple(rng.standard_normal((n, mics)) * 0.1 for _ in range(4))
        for s in spans
    }
    out = tmp_path / "fig.png"
    demo.save_pressure_figure(str(out), spans, target_a, target_b, pressures)
    assert out.exists() and out.stat().st_size > 10_000


def test_without_a_card_the_demo_raises(monkeypatch, capsys):
    """Without ``--cpu`` and without a card the demo stops before it builds
    a model; it does not carry on on the CPU."""
    demo = _load_demo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--hops", str(HOPS)])
    assert "streamed" not in capsys.readouterr().out
