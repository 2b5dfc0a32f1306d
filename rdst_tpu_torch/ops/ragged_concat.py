"""Ragged row concatenation: write valid row prefixes densely.

Port of ``rdst_tpu/ops/ragged_concat.py`` (``ragged_concat_multi`` and its
one-plane form ``ragged_concat_rows``), the
writeback of the bucketed plan (``sorts/msb.py``): planes ``(B, cap)`` whose
row b holds ``lengths[b]`` valid elements go to flat ``(total,)`` planes, row
b's prefix at the exclusive prefix sum of the lengths before it.

With host lengths (numpy or a list, the bucketed plan's case) the rows'
prefixes are static slices joined by one ``cat`` per plane.  With tensor
lengths it is one scatter per plane at the exclusive offsets; the JAX
package's sequential loop of dynamic updates exists because TPU DMA needs
static sizes.
"""
from __future__ import annotations

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.ops.prefix import exclusive_prefix_sum

__all__ = ["ragged_concat_rows", "ragged_concat_multi"]


def ragged_concat_rows(src: torch.Tensor, lengths, total: int,
                       fill: int = 0xFFFFFFFF) -> torch.Tensor:
    """Concatenate the valid row prefixes of ``src`` (B, cap) into
    ``(total,)``."""
    return ragged_concat_multi([src], lengths, total, fill)[0]


def ragged_concat_multi(planes, lengths, total: int, fill: int = 0xFFFFFFFF):
    """Concatenate the valid row prefixes of each ``(B, cap)`` plane into a
    ``(total,)`` plane; positions past the last prefix hold ``fill`` (its low
    bits, for a narrower plane)."""
    if not isinstance(lengths, torch.Tensor):
        lens = np.asarray(lengths).astype(np.int64)
        outs = []
        for p in planes:
            pieces = [p[b, : int(lens[b])] for b in range(len(lens))
                      if int(lens[b]) > 0]
            cat = P.cat(pieces) if pieces else p.reshape(-1)[:0]
            if cat.shape[0] < total:
                cat = P.cat([cat, P.fill_like(total - cat.shape[0], fill, p)])
            outs.append(cat[:total])
        return outs
    B, cap = planes[0].shape
    lengths = lengths.to(torch.int64)
    pos = torch.arange(cap, device=lengths.device)
    dest = exclusive_prefix_sum(lengths)[:, None] + pos
    keep = (pos < lengths[:, None]) & (dest < total)
    dest = dest[keep]
    outs = []
    for p in planes:
        o = P.fill_like(total, fill, p)
        P.sview(o)[dest] = P.sview(p)[keep]
        outs.append(o)
    return outs
