"""Build and load the hand-written Hopper kernels (``apvast_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` into its own
shared library with a plain C interface, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded from ``apvast_torch/_build``.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all;
the first kernel call builds every kernel that way. Nothing here runs at
import time: this module imports on a machine with no CUDA toolkit.

Every C entry point takes device pointers, sizes and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; :func:`launch` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
KERNEL_SOURCES = (
    "streaming_conv", "rowwise_conv", "lag_corr", "skew_assembly", "statistics", "whiten",
    "subspace", "jacobi_eigh", "output_filter", "chol_tri_inverse",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}  # loaded libraries, one per process


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def _library_path(name: str) -> str:
    h = hashlib.sha256()
    for src in [f"{name}.cu", *sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    digest = hashlib.sha256(h.digest() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build_all(names=KERNEL_SOURCES) -> dict[str, tuple[float, str]]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns, per source built, the seconds
    it took and nvcc's output (``-Xptxas -v``: registers, shared memory,
    spills); raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp, out, time.perf_counter(),
        )
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        raw, _ = proc.communicate()
        log = raw.decode(errors="replace")
        built[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    lib = _libs.get(name)
    if lib is None:
        if not os.path.exists(_library_path(name)):
            build_all()
        lib = ctypes.CDLL(_library_path(name))
        _libs[name] = lib
    return lib


def launch(name: str, entry: str, *args) -> None:
    """Call the C entry point ``entry`` of ``csrc/<name>.cu`` on the current
    CUDA stream. ``args`` are tensors (passed as device pointers), None (a
    null pointer), Python ints (passed as C ints) and Python floats (passed
    as C floats); raises if the launch reports an error."""
    fn = getattr(library(name), entry)
    argtypes, values = [], []
    for a in args:
        if a is None or isinstance(a, torch.Tensor):
            argtypes.append(ctypes.c_void_p)
            values.append(None if a is None else a.data_ptr())
        elif isinstance(a, float):
            argtypes.append(ctypes.c_float)
            values.append(a)
        else:
            argtypes.append(ctypes.c_int)
            values.append(int(a))
    argtypes.append(ctypes.c_void_p)
    values.append(torch.cuda.current_stream().cuda_stream)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*values)
    if err != 0:
        raise RuntimeError(f"{name}.cu:{entry} launch failed: cudaError {err}")


def check_input(
    t: torch.Tensor,
    name: str,
    ndim: int,
    device: torch.device | None = None,
    cpu_float64: bool = False,
) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``ndim`` dims
    (on ``device`` when given); ``cpu_float64`` also takes float64 on the
    CPU, where the wrapper's plain version computes in it."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.float32 and not (
        cpu_float64 and t.dtype == torch.float64 and t.device.type == "cpu"
    ):
        raise ValueError(f"{name} must be float32 (a float32 kernel), got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} on unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
