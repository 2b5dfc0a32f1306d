"""ctypes bindings for the native host runtime (``rdst_host.cpp``).

Port of ``rdst_tpu/native/host.py`` with a loader of its own.  The source
beside this file compiles at first use with ``g++`` (the flags of
``rdst_tpu/native/Makefile``) into ``build/rdst_tpu_torch_host/<hash>/`` at
the checkout root.  The hash covers the source, the flags, ``g++
--version`` and the host CPU, so a library built with ``-march=native`` on
one CPU never loads on another.  A build writes a temporary file and
renames it into place, so processes that build at once do not collide.

A missing ``g++`` or a failed build raises ``RuntimeError`` with the
compiler's output: there is no fallback.  The numpy versions
(:func:`host_radix_sort_plain`, :func:`host_histogram_plain`) compute the
same results for the tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "host_radix_sort",
    "host_histogram",
    "host_radix_sort_plain",
    "host_histogram_plain",
]

_SRC = Path(__file__).resolve().parent / "rdst_host.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rdst_tpu_torch_host"
#: The compiler, found on PATH unless it is a path.
CXX = "g++"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
          "-shared", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _cpu_id() -> str:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor() or platform.machine()
    keep = []
    for key in ("model name", "flags"):
        keep += [ln for ln in lines if ln.split(":")[0].strip() == key][:1]
    return "\n".join(keep) or platform.machine()


def _compiler() -> str:
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the host runtime cannot be built")
    return cxx


def _target(cxx: str) -> Path:
    """Where the library built by ``cxx`` from this source lives: a
    directory named by a hash of the source, the flags, the compiler's
    version and the host CPU."""
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             timeout=60)
    h = hashlib.sha256()
    for part in (_SRC.read_bytes(), " ".join(_FLAGS).encode(),
                 version.stdout.encode(), _cpu_id().encode()):
        h.update(part)
        h.update(b"\0")
    return _BUILD_DIR / h.hexdigest()[:16] / "librdst_host.so"


def _build() -> Path:
    cxx = _compiler()
    out = _target(cxx)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"librdst_host.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) building "
                           f"{_SRC.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """The library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            i64 = ctypes.c_int64
            u32p = ctypes.POINTER(ctypes.c_uint32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            i64p = ctypes.POINTER(ctypes.c_int64)
            for name, args in (
                ("host_radix_sort_u32", [u32p, i64]),
                ("host_radix_sort_u64", [u64p, i64]),
                ("host_radix_sort_u32_pairs", [u32p, u32p, i64]),
                ("host_radix_sort_u64_pairs", [u64p, u32p, i64]),
                ("histogram_u32", [u32p, i64, ctypes.c_int, i64p]),
            ):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded; raises ``RuntimeError``
    when it cannot be."""
    return _load() is not None


def _check(keys: np.ndarray, payload: np.ndarray | None):
    if keys.ndim != 1:
        raise ValueError("host_radix_sort: keys must be 1-D")
    if keys.dtype not in (np.uint32, np.uint64):
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    if payload is not None and payload.shape != keys.shape:
        raise ValueError("host_radix_sort: payload and keys differ in length")


def host_radix_sort(keys: np.ndarray, payload: np.ndarray | None = None):
    """Stable LSD radix sort of host arrays, in place: u32 or u64 keys, an
    optional u32 payload.  Returns ``(keys, payload)``; an argument that was
    not contiguous (or a payload of another dtype) is sorted as a copy."""
    keys = np.ascontiguousarray(keys)
    if payload is not None:
        payload = np.ascontiguousarray(payload, dtype=np.uint32)
    _check(keys, payload)
    lib = _load()
    n = keys.shape[0]
    bits = 32 if keys.dtype == np.uint32 else 64
    kp = keys.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint32 if bits == 32 else ctypes.c_uint64))
    if payload is None:
        getattr(lib, f"host_radix_sort_u{bits}")(kp, n)
    else:
        pp = payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        getattr(lib, f"host_radix_sort_u{bits}_pairs")(kp, pp, n)
    return keys, payload


def host_histogram(keys: np.ndarray, level: int) -> np.ndarray:
    """The 256-bin count (int64) of byte ``level`` of u32 keys."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    if not 0 <= level < 4:
        raise ValueError(f"level {level} is not a byte of a u32 key")
    lib = _load()
    out = np.zeros(256, dtype=np.int64)
    lib.histogram_u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        keys.size,
        level,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def host_radix_sort_plain(keys: np.ndarray, payload: np.ndarray | None = None):
    """:func:`host_radix_sort` in numpy (a stable argsort), for the tests."""
    keys = np.ascontiguousarray(keys)
    if payload is not None:
        payload = np.ascontiguousarray(payload, dtype=np.uint32)
    _check(keys, payload)
    order = np.argsort(keys, kind="stable")
    keys[:] = keys[order]
    if payload is not None:
        payload[:] = payload[order]
    return keys, payload


def host_histogram_plain(keys: np.ndarray, level: int) -> np.ndarray:
    """:func:`host_histogram` in numpy, for the tests."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    return np.bincount((keys >> np.uint32(level * 8)) & 0xFF,
                       minlength=256).astype(np.int64)
