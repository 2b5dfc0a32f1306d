"""LSB-family plans: sorts with histogram-driven level compaction.

Port of ``rdst_tpu/sorts/lsb.py``.  Byte levels whose histogram is a single
spike are constant: they are dropped, the varying bytes repack into the
fewest words (the most significant one narrowed to u8/u16 when it holds one
or two bytes), one sort runs over the packed words, and the constant bytes
return afterwards with bit operations.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.keys import _digit_i64
from rdst_tpu_torch.sorts.comparative import comparative_sort

__all__ = ["packed_sort", "compaction_plan"]


def compaction_plan(counts: np.ndarray) -> tuple[list[int], list[int | None]]:
    """From (L, 256) histograms: varying levels (LSB-first indices) and the
    constant byte per level (None if varying)."""
    L = counts.shape[0]
    varying: list[int] = []
    const_byte: list[int | None] = []
    n = counts[0].sum()
    for lvl in range(L):
        nz = np.nonzero(counts[lvl])[0]
        if len(nz) == 1 and counts[lvl][nz[0]] == n:
            const_byte.append(int(nz[0]))
        else:
            const_byte.append(None)
            varying.append(lvl)
    return varying, const_byte


def _pack_levels(words: Sequence[torch.Tensor], varying: list[int]):
    """Pack the varying byte levels into tight words, the most significant
    narrowed to u8/u16 when it holds one or two bytes."""
    vb = len(varying)
    n_packed = max(1, -(-vb // 4))
    packed = [0] * n_packed
    for p, lvl in enumerate(varying):
        widx = n_packed - 1 - (p // 4)
        packed[widx] = packed[widx] | (_digit_i64(words, lvl) << ((p % 4) * 8))
    n = words[0].shape[0]
    dev = words[0].device
    out = [
        P.narrow(w, torch.uint32) if torch.is_tensor(w)
        else P.full(n, 0, torch.uint32, dev)
        for w in packed
    ]
    msw_bytes = vb - 4 * (n_packed - 1)
    if msw_bytes in (1, 2):
        out[0] = P.narrow(P.widen(out[0]), P.unsigned_of_width(msw_bytes))
    return out


def _unpack_levels(packed, varying, const_byte, n_words):
    """Rebuild the original words from packed words + constant bytes."""
    n = packed[0].shape[0]
    dev = packed[0].device
    words = [torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(n_words)]
    vpos = {lvl: p for p, lvl in enumerate(varying)}
    for lvl in range(len(const_byte)):
        widx = n_words - 1 - (lvl // 4)
        shift = (lvl % 4) * 8
        if const_byte[lvl] is not None:
            words[widx] = words[widx] | (const_byte[lvl] << shift)
        else:
            words[widx] = words[widx] | (_digit_i64(packed, vpos[lvl]) << shift)
    return [P.narrow(w, torch.uint32) for w in words]


def packed_sort(
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor],
    counts: np.ndarray | None,
    *,
    stable: bool = True,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Level-compacted sort (the Lsb/LrLsb/Ska/Recombinating plan)."""
    words = list(words)
    if counts is None:
        return comparative_sort(words, payloads, stable=stable)
    n_bytes = counts.shape[0]
    varying, const_byte = compaction_plan(counts)
    if not varying:
        # every level constant: all keys equal — identity (stable)
        return words, list(payloads)
    n_packed = -(-len(varying) // 4)
    msw_bytes = len(varying) - 4 * (n_packed - 1)
    if len(varying) == n_bytes and n_packed == len(words) and msw_bytes > 2:
        # nothing to compact and no width to shave
        return comparative_sort(words, payloads, stable=stable)
    packed = _pack_levels(words, varying)
    out_packed, out_payloads = comparative_sort(packed, payloads, stable=stable)
    out_words = _unpack_levels(out_packed, varying, const_byte, len(words))
    return out_words, out_payloads
