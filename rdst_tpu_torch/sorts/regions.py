"""Regions plan: the low-memory plan.

Port of the plan selection around ``rdst_tpu/sorts/regions.py``.  Below
``config.low_mem_threshold_bytes`` of operand planes the Regions pick runs
the level-compacted sort, as in the JAX package.  The chunked sort with a
bitonic merge tree (``chunked_sort``) needs the merge kernels B4/B5 and is
ROADMAP A6, so above the threshold the plan raises.
"""
from __future__ import annotations

from rdst_tpu_torch import config
from rdst_tpu_torch.sorts.lsb import packed_sort

__all__ = ["regions_plan", "chunked_sort"]


def chunked_sort(words, payloads, *, stable: bool = False, n_chunks: int = 4):
    raise NotImplementedError("chunked low-memory sort: ROADMAP A6")


def regions_plan(words, payloads, counts, *, stable: bool):
    n = int(words[0].shape[0])
    working_set = n * (len(words) + len(payloads)) * 4
    if working_set < config.low_mem_threshold_bytes:
        return packed_sort(words, payloads, counts, stable=stable)
    return chunked_sort(words, payloads, stable=stable)
