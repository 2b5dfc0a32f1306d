"""Regions plan: the low-memory plan.

Port of ``rdst_tpu/sorts/regions.py`` and of the Regions entry of the JAX
package's plan registry.  Below ``config.low_mem_threshold_bytes`` of
operand planes a Regions pick runs the level-compacted sort, as in the JAX
package.  Above it, ``chunked_sort`` bounds the sort's workspace: the input
splits into four power-of-two chunks, each chunk sorts on its own (so the
fused executor's workspace scales with the chunk), and a bitonic merge tree
(``ops/merge.py``, kernels B4/B5, in place) merges the sorted runs.
"""
from __future__ import annotations

from typing import Sequence

import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch.ops.merge import merge_many
from rdst_tpu_torch.sorts.comparative import comparative_sort
from rdst_tpu_torch.sorts.lsb import packed_sort

__all__ = ["regions_plan", "chunked_sort"]


def chunked_sort(
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor],
    *,
    stable: bool = False,
    n_chunks: int = 4,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Low-memory plan: ``n_chunks`` chunk sorts + a bitonic merge tree."""
    words = list(words)
    payloads = list(payloads)
    n = int(words[0].shape[0])
    n_words = len(words)
    if n < n_chunks * 2 or n_chunks < 2:
        return comparative_sort(words, payloads, stable=stable)

    # chunk length: a power of two for the merge network
    m = 1
    while m * n_chunks < n:
        m *= 2
    # Chunk sorts must be stable when the call is, or when payloads ride: a
    # pad row ties with a real all-ones key, and an unstable sort could put
    # the pad first and drop the real payload at the truncation.  Keys-only
    # unstable sorts skip the stability plane.
    stable_chunks = stable or bool(payloads)
    # No name here keeps the runs: merge_many lets each go once merged.
    merged = merge_many(
        _sorted_chunks(words + payloads, n_words, m * n_chunks, m,
                       stable_chunks),
        n_words, stable=True,
    )
    out = [p[:n] for p in merged]
    return out[:n_words], out[n_words:]


def _sorted_chunks(planes, n_words, total, m, stable):
    """Pad the planes to ``total`` (all-ones keys, zero payloads) and sort
    each length-``m`` chunk; returns the sorted runs."""
    pad = total - int(planes[0].shape[0])
    if pad:
        planes = [
            P.cat([p, P.fill_like(pad, -1 if i < n_words else 0, p)])
            for i, p in enumerate(planes)
        ]
    runs = []
    for c in range(total // m):
        chunk = [p[c * m: (c + 1) * m] for p in planes]
        cw, cp = comparative_sort(chunk[:n_words], chunk[n_words:], stable=stable)
        runs.append(cw + cp)
    return runs


def regions_plan(words, payloads, counts, *, stable: bool):
    n = int(words[0].shape[0])
    working_set = n * (len(words) + len(payloads)) * 4
    if working_set < config.low_mem_threshold_bytes:
        return packed_sort(words, payloads, counts, stable=stable)
    return chunked_sort(words, payloads, stable=stable)
