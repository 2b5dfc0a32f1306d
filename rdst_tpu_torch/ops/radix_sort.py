"""LSD radix sort of the fused executor (kernel B8).

Rows whose key planes sum to at most 8 bytes, with at most one payload plane
of at most 4 bytes, sort by one stable pass per key byte, least significant
first: each pass moves every plane to the stable order of one 8-bit digit.
Eight passes of a 64-bit key move each row 8 times, where the bitonic
network (``ops/fused_sort.py``) takes O(log^2 n) compare-exchange stages;
the passes need no index plane to be stable and no pad.  The JAX package
has no such path: a TPU has no fast scatter, Hopper has one.

:func:`radix_pass` is the kernel wrapper: one launch of
``csrc/radix_pass.cu`` (B8) from CUDA planes into CUDA planes, on a level's
digit counts from B1 (``ops/histogram.py``, on :func:`hist_words`) and one
:func:`pass_scratch` buffer that the launch zeroes.  :func:`radix_pass_plain`
is its plain version in PyTorch, a stable counting-sort pass.  A stable pass
has one output, so the two agree bit for bit, pass by pass.
:func:`radix_sort` runs every pass: on the card one B1 launch gives all the
levels' histograms, one scratch buffer serves every pass, and the passes
ping-pong between two plane sets, so the caller's planes are read and never
written; CPU planes take the plain passes.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from rdst_tpu_torch import _build
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.ops import histogram
from rdst_tpu_torch.ops.histogram import RADIX

__all__ = [
    "takes", "radix_sort", "radix_pass", "radix_pass_plain", "hist_words",
    "pass_scratch", "RADIX_PASS", "TILE", "MAX_KEY_BYTES", "MAX_ROWS",
]

#: Key bytes the passes take: one pass each.
MAX_KEY_BYTES = 8
#: Rows one sort may hold: a look-back flag's count has 30 bits
#: (kCountMask in csrc/radix_pass.cu).
MAX_ROWS = (1 << 30) - 1
#: Rows of one B8 tile (kTile = kThreads * kItems in csrc/radix_pass.cu).
TILE = 4096

RADIX_PASS = _build.Kernel(
    "radix_pass",
    "rdst_radix_pass",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p],
)


def takes(words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor] = ()) -> bool:
    """True when the rows' shape suits the radix passes: key planes of at
    most 8 bytes together, at most one payload plane of at most 4 bytes,
    and 1 to MAX_ROWS rows.  Shapes only: the device is not part of it."""
    n = int(words[0].shape[0])
    if not 1 <= n <= MAX_ROWS or len(payloads) > 1:
        return False
    if any(p.dtype.itemsize > 4 for p in payloads):
        return False
    return sum(p.dtype.itemsize for p in words) <= MAX_KEY_BYTES


def _digit(dtypes: Sequence[torch.dtype], byte: int) -> tuple[int, int]:
    """(key plane, bit shift) of key byte ``byte`` (0: the least
    significant byte of the last key plane)."""
    for j in range(len(dtypes) - 1, -1, -1):
        width = dtypes[j].itemsize
        if byte < width:
            return j, 8 * byte
        byte -= width
    raise ValueError("byte beyond the key planes")


def _check(planes, n_keys, byte):
    if not 1 <= n_keys <= len(planes) <= n_keys + 1:
        raise ValueError("key planes and at most one payload plane")
    n = int(planes[0].shape[0])
    for p in planes:
        if p.dtype not in P.UNSIGNED or p.shape != (n,):
            raise ValueError("planes must be (n,) u8/u16/u32")
    if not 1 <= n <= MAX_ROWS:
        raise ValueError(f"1..{MAX_ROWS} rows, got {n}")
    if sum(p.dtype.itemsize for p in planes[:n_keys]) > MAX_KEY_BYTES:
        raise ValueError(f"key planes of more than {MAX_KEY_BYTES} bytes")
    _digit([p.dtype for p in planes[:n_keys]], byte)


def radix_pass_plain(planes, n_keys: int, byte: int) -> list[torch.Tensor]:
    """Plain PyTorch version of B8: every plane in the stable order of key
    byte ``byte``."""
    planes = list(planes)
    _check(planes, n_keys, byte)
    RADIX_PASS.plain_calls += 1
    j, shift = _digit([p.dtype for p in planes[:n_keys]], byte)
    digit = (P.widen(planes[j]) >> shift) & (RADIX - 1)
    order = torch.argsort(digit, stable=True)
    return [P.take(p, order) for p in planes]


def hist_words(keys: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The key as u32 words for B1 (level l = key byte l): the planes
    themselves when they are u32, else the key packed into one or two
    words."""
    if all(p.dtype == torch.uint32 for p in keys):
        return list(keys)
    lo = hi = 0
    s = 0
    for p in reversed(keys):
        v = P.widen(p)
        w = 8 * p.dtype.itemsize
        if s >= 32:
            hi = hi | (v << (s - 32))
        elif s + w <= 32:
            lo = lo | (v << s)
        else:
            lo = lo | ((v << s) & 0xFFFFFFFF)
            hi = hi | (v >> (32 - s))
        s += w
    words = [lo] if s <= 32 else [hi, lo]
    return [P.narrow(w, torch.uint32) for w in words]


def pass_scratch(n: int, device) -> torch.Tensor:
    """The scratch of a pass over ``n`` rows: a look-back flag a tile and
    digit, then the tile counter.  Each launch zeroes it, so one buffer
    serves every pass of a sort."""
    return torch.empty(-(-n // TILE) * RADIX + 1, dtype=torch.int32, device=device)


def radix_pass(src, dst, n_keys: int, byte: int, counts: torch.Tensor,
               scratch: torch.Tensor) -> list[torch.Tensor]:
    """B8: every plane of ``src`` (``n_keys`` key planes, most significant
    first, then at most one payload plane) into ``dst`` in the stable order
    of key byte ``byte``.  ``counts``: the level's 256 int64 digit counts
    (B1's); ``scratch``: :func:`pass_scratch` of the length.  CUDA planes
    only; returns ``dst``."""
    src, dst = [p.contiguous() for p in src], list(dst)
    _check(src, n_keys, byte)
    dev, n = _build.check_cuda_planes(src, P.UNSIGNED)
    if (len(dst) != len(src) or any(
            d.dtype != p.dtype or d.shape != p.shape or d.device != dev
            or not d.is_contiguous() for d, p in zip(dst, src))):
        raise ValueError("dst must match src plane for plane")
    if (counts.device != dev or counts.dtype != torch.int64 or counts.numel() < RADIX
            or scratch.device != dev or scratch.dtype != torch.int32
            or scratch.numel() < -(-n // TILE) * RADIX + 1):
        raise ValueError("counts: 256 int64 on the planes' card; scratch: pass_scratch(n)")
    k = len(src)
    j, shift = _digit([p.dtype for p in src[:n_keys]], byte)
    ins = (ctypes.c_void_p * k)(*[p.data_ptr() for p in src])
    outs = (ctypes.c_void_p * k)(*[p.data_ptr() for p in dst])
    widths = (ctypes.c_int * k)(*[p.dtype.itemsize for p in src])
    RADIX_PASS.launch(
        dev, ins, outs, widths, k, j, shift, n, ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_void_p(scratch.data_ptr()), _build.stream_of(src[0]),
    )
    return dst


def radix_sort(
    words: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor] = ()
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Stable sort of key planes ``words`` (most significant first, u8/u16/
    u32, at most 8 bytes together) and at most one payload plane, by one
    pass per key byte.  New planes; the inputs are not written."""
    planes = [p.contiguous() for p in list(words) + list(payloads)]
    nk = len(words)
    passes = sum(p.dtype.itemsize for p in words)
    if planes[0].device.type == "cpu":
        for b in range(passes):
            planes = radix_pass_plain(planes, nk, b)
        return planes[:nk], planes[nk:]
    _check(planes, nk, 0)
    n = int(planes[0].shape[0])
    counts = histogram.histogram_cuda(hist_words(planes[:nk]), passes)
    scratch = pass_scratch(n, planes[0].device)
    bufs = [[torch.empty_like(p) for p in planes]]
    if passes > 1:
        bufs.append([torch.empty_like(p) for p in planes])
    src = planes
    for b in range(passes):
        src = radix_pass(src, bufs[b % 2], nk, b, counts[b * RADIX:(b + 1) * RADIX],
                         scratch)
    return src[:nk], src[nk:]
