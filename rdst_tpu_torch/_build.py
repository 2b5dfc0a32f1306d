"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` compile at first use with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and link into
one shared library with a plain C interface, written to
``build/rdst_tpu_torch/`` at the checkout root and named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
at once.  The library loads through ctypes: every pointer and the stream
pass as ``c_void_p``.  Each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises if that is
not 0.  A missing ``nvcc`` or a failed build raises too: there is no
fallback.

The kernel gate is the tensors' device.  Each wrapper in ``ops/`` launches
its kernel for CUDA tensors and runs its plain PyTorch version, which sits
beside it in the same module, only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["Kernel", "KERNELS", "library", "stream_of", "check_cuda_planes", "sm_count"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "rdst_tpu_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: Seconds the first :func:`library` call took (build included), or None.
build_seconds: float | None = None

#: name -> Kernel, for callers that report every kernel (chip_smoke.py).
KERNELS: dict[str, "Kernel"] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (
        home and str(Path(home) / "bin" / "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(procs: list[subprocess.Popen]) -> None:
    """Wait for every process; raise with the output of the first failure."""
    failed = []
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}"
                          f"\n{out}\n{err}")
    if failed:
        raise RuntimeError(failed[0])


def _build() -> Path:
    """Compile every source to an object file, all at once (one nvcc each),
    then link them into the shared library."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = _BUILD_DIR / f"librdst_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    compile_flags = [f for f in _FLAGS if f != "-shared"]
    objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    _run([
        subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for src, obj in zip(sources, objs)
    ])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([subprocess.Popen([nvcc, *_FLAGS, "-o", str(tmp), *map(str, objs)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(_build()))
            lib.rdst_error_string.argtypes = [ctypes.c_int]
            lib.rdst_error_string.restype = ctypes.c_char_p
            _lib = lib
            build_seconds = time.perf_counter() - t0
        return _lib


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


class Kernel:
    """One C entry point of the kernel library and its counters.

    ``launches`` counts kernel launches and nothing else; ``plain_calls``
    counts runs of the plain PyTorch version."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.plain_calls = 0
        self._fn = None
        KERNELS[name] = self

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args)
        if err != 0:
            msg = library().rdst_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err}: {msg}")
        self.launches += 1


def check_cuda_planes(planes, dtypes) -> tuple[torch.device, int]:
    """Validate planes for a kernel: 1-D, contiguous, one CUDA device, one
    length, dtype among ``dtypes``.  Returns (device, length)."""
    dev = planes[0].device
    n = planes[0].shape[0] if planes[0].ndim == 1 else -1
    for p in planes:
        if p.device != dev or dev.type != "cuda":
            raise ValueError("kernel planes must lie on one CUDA device")
        if p.ndim != 1 or p.shape[0] != n:
            raise ValueError("kernel planes must be 1-D and of one length")
        if not p.is_contiguous():
            raise ValueError("kernel planes must be contiguous")
        if p.dtype not in dtypes:
            raise TypeError(f"kernel plane dtype {p.dtype} not in {dtypes}")
    return dev, n


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
