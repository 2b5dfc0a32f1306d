"""Multi-level digit histograms with fused sortedness detection (kernel B1).

Port of ``rdst_tpu/ops/histogram.py``.  One pass over the key words yields
every byte level's 256-bin histogram, whether each level's digits are
nondecreasing in array order, and the longest lexicographically
nondecreasing prefix of the full key, all in one int64 buffer
``[counts (L*256) | sorted (L) | prefix]`` that reaches the host in one copy.

CUDA tensors go through the hand-written kernel ``csrc/histogram.cu``
(which replaces the Pallas ``_hist_kernel``, histogram.py:180 and :258);
CPU tensors through :func:`histogram_plain`, its plain PyTorch version.
Both return the same buffer bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch import _build
from rdst_tpu_torch import _planes as P

RADIX = 256
MAX_WORDS = 8  # kMaxWords in csrc/histogram.cu: keys of up to 32 bytes
MAX_LEVELS = 32
_THREADS = 512  # kThreads in csrc/histogram.cu
_BLOCKS_PER_SM = 4

__all__ = [
    "HistogramResult", "multi_level_histogram", "level_histogram",
    "histogram_plain", "histogram_cuda", "HISTOGRAM",
]

HISTOGRAM = _build.Kernel(
    "multi_level_histogram",
    "rdst_histogram",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)


@dataclasses.dataclass(frozen=True)
class HistogramResult:
    """Per-level global histograms + sortedness, on the host for planning.

    ``counts[l]`` is the 256-bin histogram of byte level ``l`` (0 = least
    significant); ``level_sorted[l]`` is True iff that level's digits are
    nondecreasing in the current array order; ``sorted_prefix`` is the
    length of the longest lexicographically nondecreasing prefix of the
    full key."""

    counts: np.ndarray  # (L, 256) int64
    level_sorted: np.ndarray  # (L,) bool
    sorted_prefix: int = 0

    @property
    def n(self) -> int:
        return int(self.counts[0].sum())

    def constant_levels(self) -> np.ndarray:
        """Levels where one digit holds everything — skippable forever."""
        return (self.counts.max(axis=1) == self.counts.sum(axis=1)).astype(bool)

    def fully_sorted(self) -> bool:
        return bool(self.level_sorted.all())


def _check(words: Sequence[torch.Tensor], level0: int, n_levels: int) -> None:
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"1..{MAX_WORDS} key words, got {len(words)}")
    if not 1 <= n_levels <= MAX_LEVELS or level0 < 0:
        raise ValueError(f"1..{MAX_LEVELS} levels, got {n_levels}")
    if level0 + n_levels > 4 * len(words):
        raise ValueError("levels beyond the key words")


def histogram_plain(
    words: Sequence[torch.Tensor], n_levels: int, level0: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same int64 buffer."""
    words = list(words)
    _check(words, level0, n_levels)
    HISTOGRAM.plain_calls += 1
    n = int(words[0].shape[0])
    nw = len(words)
    wide = [P.widen(w) for w in words]
    counts, flags = [], []
    for lv in range(level0, level0 + n_levels):
        d = (wide[nw - 1 - lv // 4] >> ((lv % 4) * 8)) & 0xFF
        counts.append(torch.bincount(d, minlength=RADIX))
        flags.append(torch.all(d[1:] >= d[:-1]))
    if n > 1:
        gt = P.lex_gt([w[:-1] for w in wide], [w[1:] for w in wide])
        first = torch.argmax(gt.to(torch.int32)) + 1
        prefix = torch.where(gt.any(), first, torch.full_like(first, n))
    else:
        prefix = torch.tensor(n, device=words[0].device)
    return torch.cat([
        torch.stack(counts).reshape(-1),
        torch.stack(flags).to(torch.int64),
        prefix.reshape(1).to(torch.int64),
    ])


def histogram_cuda(
    words: Sequence[torch.Tensor], n_levels: int, level0: int = 0
) -> torch.Tensor:
    """Launch ``csrc/histogram.cu``; returns the int64 buffer on the card."""
    words = [w.contiguous() for w in words]
    _check(words, level0, n_levels)
    dev, n = _build.check_cuda_planes(words, (torch.uint32,))
    out = torch.empty(
        n_levels * RADIX + n_levels + 1, dtype=torch.int64, device=dev
    )
    ptrs = (ctypes.c_void_p * MAX_WORDS)(*[w.data_ptr() for w in words])
    grid = max(1, min(-(-n // _THREADS), _build.sm_count(dev) * _BLOCKS_PER_SM))
    HISTOGRAM.launch(
        dev, ptrs, len(words), level0, n_levels, n,
        ctypes.c_void_p(out.data_ptr()), grid, _build.stream_of(out),
    )
    return out


def _histogram(words, n_levels: int, level0: int = 0) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if words[0].device.type == "cuda":
        return histogram_cuda(words, n_levels, level0)
    if words[0].device.type != "cpu":
        raise ValueError(f"no histogram for device {words[0].device}")
    return histogram_plain(words, n_levels, level0)


def unpack(buf: np.ndarray, n_levels: int) -> HistogramResult:
    """Host buffer -> HistogramResult."""
    nc = n_levels * RADIX
    return HistogramResult(
        buf[:nc].reshape(n_levels, RADIX).copy(),
        buf[nc : nc + n_levels] == 1,
        int(buf[nc + n_levels]),
    )


def multi_level_histogram(words, n_bytes: int) -> HistogramResult:
    """All-level histograms + sortedness in one pass; one host copy."""
    buf = _histogram(list(words), n_bytes).cpu().numpy()
    return unpack(buf, n_bytes)


def level_histogram(words, level: int) -> torch.Tensor:
    """One level's 256-bin histogram (int64), left on the words' device."""
    words = list(words)
    word = words[len(words) - 1 - level // 4]
    return _histogram([word], 1, level % 4)[:RADIX]
