"""Bitonic merge of two sorted multi-plane sequences (plain PyTorch).

Port of the stage loop of ``rdst_tpu/ops/merge.py`` ``merge_sorted``
(merge.py:57-112), which ``Sorter._presorted_merge`` needs.  The JAX
package routes large merges through the Pallas merge kernels B4/B5
(``rdst_tpu/ops/pallas_merge.py``); their port, and ``merge_many``, are
ROADMAP A6.  Every stage here is one pass of selects through device memory.
"""
from __future__ import annotations

from typing import Sequence

import torch

from rdst_tpu_torch import _planes as P

__all__ = ["merge_sorted"]


def merge_sorted(
    planes_a: Sequence[torch.Tensor],
    planes_b: Sequence[torch.Tensor],
    n_keys: int,
    *,
    stable: bool = False,
) -> list[torch.Tensor]:
    """Merge two sorted plane lists (first ``n_keys`` planes are the key,
    most significant first) whose total length is a power of two.

    ``stable=True`` adds a tiebreak plane (a-side first, original order
    within a side) so equal keys merge stably."""
    la = planes_a[0].shape[0]
    lb = planes_b[0].shape[0]
    total = la + lb
    if total & (total - 1):
        raise ValueError("merge_sorted needs a power-of-two total length")
    planes_a = list(planes_a)
    planes_b = list(planes_b)
    nk = n_keys
    dev = planes_a[0].device
    if stable:
        ia = P.arange(la, torch.uint32, dev)
        ib = P.narrow(torch.arange(la, total, device=dev), torch.uint32)
        planes_a = planes_a[:nk] + [ia] + planes_a[nk:]
        planes_b = planes_b[:nk] + [ib] + planes_b[nk:]
        nk += 1

    # bitonic: concat(a, reverse(b)), then log2(total) split stages
    z = [P.cat([pa, P.flip(pb)]) for pa, pb in zip(planes_a, planes_b)]
    s = total // 2
    while s >= 1:
        zs = [p.reshape(total // (2 * s), 2, s) for p in z]
        lo = [p[:, 0, :] for p in zs]
        hi = [p[:, 1, :] for p in zs]
        swap = P.lex_gt(lo[:nk], hi[:nk])
        z = [
            P.interleave(P.where(swap, h, l), P.where(swap, l, h))
            for l, h in zip(lo, hi)
        ]
        s //= 2
    if stable:
        z = z[:n_keys] + z[n_keys + 1:]
    return z
