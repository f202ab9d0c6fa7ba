"""The port stands alone: importing ``apvast_torch`` loads no JAX module and
nothing of ``apvast_tpu``, running the port's demo
(``examples/run_demo_torch.py``) loads neither, and no source file of the
port (nor ``chip_smoke.py``, nor the demo) imports either."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|apvast_tpu)\b", re.MULTILINE)


def test_import_loads_no_jax():
    modules = [
        "apvast_torch",
        "apvast_torch.models.apvast",
        "apvast_torch.ops.kernels",
        "apvast_torch.ops.kernels._build",
        "apvast_torch.utils.convert",
        "apvast_torch.utils.scenes",
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'apvast_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_demo_loads_no_jax():
    """The demo's whole run (the FD engine, 8 hops, on the CPU), then the
    modules it loaded."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('demo', 'examples/run_demo_torch.py')\n"
        "demo = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(demo)\n"
        "assert demo.main(['--cpu', '--hops', '8', '--fd']) == 0\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'apvast_tpu') or m == 'run_demo')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax():
    files = sorted((ROOT / "apvast_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "run_demo_torch.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files if _IMPORT.search(f.read_text())]
    assert offenders == []
