"""ctypes bindings of the native real-time runtime (``runtime/apvast_rt.cpp``):
lock-free single-producer/single-consumer float rings and the hop framer
(port of ``apvast_tpu/runtime/native.py``).

The library is built at first use with the system C++ compiler,

    g++ -O3 -fPIC -std=c++17 -shared -o _build/apvast_rt-<hash>.so runtime/apvast_rt.cpp

into ``apvast_torch/_build/`` under a hash of the source (as the kernels
are, ``ops/kernels/_build.py``), so an edited source is rebuilt. Nothing
is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SOURCE = os.path.join(os.path.dirname(__file__), "apvast_rt.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_LIB: ctypes.CDLL | None = None


def library_path() -> str:
    """Where the library of the current source is built."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()
    return os.path.join(_BUILD_DIR, f"apvast_rt-{digest[:16]}.so")


def load_native() -> ctypes.CDLL:
    """The loaded runtime library, built first if its source has no build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SOURCE} (rc={proc.returncode}):\n"
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    u64, ptr, f32p = ctypes.c_uint64, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
    sigs = {
        "apvast_ring_create": ([u64], ptr),
        "apvast_ring_destroy": ([ptr], None),
        "apvast_ring_capacity": ([ptr], u64),
        "apvast_ring_readable": ([ptr], u64),
        "apvast_ring_writable": ([ptr], u64),
        "apvast_ring_write": ([ptr, f32p, u64], u64),
        "apvast_ring_read": ([ptr, f32p, u64], u64),
        "apvast_ring_overruns": ([ptr], u64),
        "apvast_ring_underruns": ([ptr], u64),
        "apvast_framer_create": ([u64, u64], ptr),
        "apvast_framer_destroy": ([ptr], None),
        "apvast_framer_push": ([ptr, f32p, u64], u64),
        "apvast_framer_ready": ([ptr], u64),
        "apvast_framer_pop": ([ptr, f32p], ctypes.c_int),
        "apvast_framer_dropped": ([ptr], u64),
        "apvast_framer_writable": ([ptr], u64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = lib
    return lib


def _as_f32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _Native:
    """A handle of the native library, released by :meth:`close`."""

    _destroy = ""

    def close(self) -> None:
        if self._handle:
            getattr(self._lib, self._destroy)(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class RingBuffer(_Native):
    """Lock-free SPSC float ring buffer (audio-callback safe); its capacity
    is ``min_capacity`` rounded up to a power of two."""

    _destroy = "apvast_ring_destroy"

    def __init__(self, min_capacity: int):
        self._lib = load_native()
        self._handle = self._lib.apvast_ring_create(min_capacity)
        if not self._handle:
            raise MemoryError("ring allocation failed")

    @property
    def capacity(self) -> int:
        return self._lib.apvast_ring_capacity(self._handle)

    @property
    def readable(self) -> int:
        return self._lib.apvast_ring_readable(self._handle)

    @property
    def writable(self) -> int:
        return self._lib.apvast_ring_writable(self._handle)

    @property
    def overruns(self) -> int:
        """Short writes (the producer outpaced the consumer)."""
        return self._lib.apvast_ring_overruns(self._handle)

    @property
    def underruns(self) -> int:
        """Short reads."""
        return self._lib.apvast_ring_underruns(self._handle)

    def write(self, samples) -> int:
        """Write up to ``len(samples)`` samples; returns how many."""
        arr = np.ascontiguousarray(samples, dtype=np.float32)
        return self._lib.apvast_ring_write(self._handle, _as_f32_ptr(arr), arr.size)

    def read(self, n: int) -> np.ndarray:
        """Read up to ``n`` samples."""
        out = np.empty(n, dtype=np.float32)
        got = self._lib.apvast_ring_read(self._handle, _as_f32_ptr(out), n)
        return out[:got]


class HopFramer(_Native):
    """Reframes chunks of any size into fixed hops, buffering up to
    ``max_backlog_hops`` of them."""

    _destroy = "apvast_framer_destroy"

    def __init__(self, hop: int, max_backlog_hops: int = 8):
        self._lib = load_native()
        self.hop = hop
        self._handle = self._lib.apvast_framer_create(hop, max_backlog_hops)
        if not self._handle:
            raise MemoryError("framer allocation failed")

    def push(self, samples) -> int:
        """Push a chunk; returns the samples taken (a short write counts a
        drop)."""
        arr = np.ascontiguousarray(samples, dtype=np.float32)
        return self._lib.apvast_framer_push(self._handle, _as_f32_ptr(arr), arr.size)

    @property
    def ready(self) -> int:
        """Complete hops ready to pop."""
        return self._lib.apvast_framer_ready(self._handle)

    @property
    def dropped(self) -> int:
        return self._lib.apvast_framer_dropped(self._handle)

    @property
    def writable(self) -> int:
        """Free sample capacity (for atomic multi-framer admission)."""
        return self._lib.apvast_framer_writable(self._handle)

    def pop(self) -> np.ndarray | None:
        """One hop, or None when none is ready."""
        out = np.empty(self.hop, dtype=np.float32)
        if self._lib.apvast_framer_pop(self._handle, _as_f32_ptr(out)):
            return out
        return None
