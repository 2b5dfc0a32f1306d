"""Bitonic merge of sorted multi-plane sequences.

Port of ``rdst_tpu/ops/merge.py``: the primitive behind the presorted merge
(``Sorter._presorted_merge``) and the low-memory chunked plan's merge tree
(``sorts/regions.py``).  ``merge_sorted`` builds the bitonic sequence
``cat(a, flip(b))``; from ``_FUSED_MIN`` elements on it sorts it with the
fused merge (``ops/fused_merge.py``, kernels B4/B5, in place on the
sequence it built), and below that, or for planes the fused merge does not
take, with the plain stage loop: one pass of selects through memory per
stage.  Both run the same stages, so they give the same output.
"""
from __future__ import annotations

from typing import Sequence

import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.ops.fused_merge import (
    bitonic_merge_fused,
    fused_merge_available,
)

__all__ = ["merge_sorted", "merge_many"]

#: From this total length on, merges take the fused kernels (the JAX
#: package's value: below it launch overhead dominated on the TPU).  A
#: parameter until the H100 crossover is measured.
_FUSED_MIN = 1 << 15


def merge_sorted(
    planes_a: Sequence[torch.Tensor],
    planes_b: Sequence[torch.Tensor],
    n_keys: int,
    *,
    stable: bool = False,
) -> list[torch.Tensor]:
    """Merge two sorted plane lists (first ``n_keys`` planes are the key,
    most significant first) whose total length is a power of two.  The
    split may be unequal: ascending a then descending b is bitonic wherever
    the peak sits.

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
        order = P.arange(total, torch.uint32, dev)
        planes_a = planes_a[:nk] + [order[:la]] + planes_a[nk:]
        planes_b = planes_b[:nk] + [order[la:]] + planes_b[nk:]
        del order
        nk += 1

    # bitonic: concat(a, reverse(b)), then log2(total) split stages.  Each
    # input plane is let go once copied, so a caller that hands over its
    # only references (merge_many) holds one plane extra at the peak.
    z = []
    for j in range(len(planes_a)):
        z.append(P.cat([planes_a[j], P.flip(planes_b[j])]))
        planes_a[j] = planes_b[j] = None
    if total >= _FUSED_MIN and fused_merge_available(z):
        z = bitonic_merge_fused(z, nk, in_place=True)
    else:
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


def merge_many(
    runs: Sequence[Sequence[torch.Tensor]], n_keys: int, *, stable: bool = False
) -> list[torch.Tensor]:
    """Merge k sorted runs of one power-of-two length with a pairwise merge
    tree.

    An odd run out at a level waits for the next one, padded to the merged
    length: key planes with all-ones (they sort to the tail; the padded run
    is always the last, the b-side of its pair, so in stable mode real
    all-ones keys stay ahead of the pads), payload planes with zeros.  Pads
    therefore occupy exactly the output's tail: callers slice
    ``[:real_total]``."""
    runs = [list(r) for r in runs]
    while len(runs) > 1:
        nxt = []
        while len(runs) > 1:  # pop: merge_sorted gets the only references
            nxt.append(merge_sorted(runs.pop(0), runs.pop(0), n_keys,
                                    stable=stable))
        nxt += runs
        mx = max(int(r[0].shape[0]) for r in nxt)
        for j, r in enumerate(nxt):
            pad = mx - int(r[0].shape[0])
            if pad:
                nxt[j] = [
                    P.cat([p, P.fill_like(pad, -1 if i < n_keys else 0, p)])
                    for i, p in enumerate(r)
                ]
        runs = nxt
    return runs[0]
