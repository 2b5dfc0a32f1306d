"""Static-plan sort entry point over word planes.

Port of ``rdst_tpu/engine.py``.  ``sort_words`` runs a plan chosen by name,
with no tuner:

  auto         - packed level compaction when ``counts`` are given,
                 else the comparative executor
  comparative  - ``sorts/comparative.py`` (fused bitonic / ``lex_sort``)
  packed       - force level compaction (requires ``counts``)
  bucketed     - MSB partition + batched per-bucket sorts (requires
                 ``counts``; ``sorts/msb.py``)
  lowmem       - chunked low-memory sort with the fused merge tree
                 (``sorts/regions.py``)
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch.sorts.comparative import comparative_sort
from rdst_tpu_torch.sorts.lsb import packed_sort
from rdst_tpu_torch.sorts.msb import bucketed_sort
from rdst_tpu_torch.sorts.regions import chunked_sort

__all__ = ["sort_words"]


def sort_words(
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor] = (),
    *,
    stable: bool = False,
    plan: str = "auto",
    counts: np.ndarray | None = None,
):
    """Sort uint32 word planes (most significant first) + payloads.

    ``counts`` is an optional host-side ``(L, 256)`` histogram of the byte
    planes (``multi_level_histogram(...).counts``); with it, ``auto`` drops
    constant byte planes before sorting."""
    if plan == "auto":
        plan = "packed" if counts is not None else "comparative"
    if plan == "comparative":
        return comparative_sort(words, payloads, stable=stable)
    if plan == "packed":
        if counts is None:
            raise ValueError("plan='packed' requires counts")
        return packed_sort(words, payloads, counts, stable=stable)
    if plan == "bucketed":
        if counts is None:
            raise ValueError("plan='bucketed' requires counts")
        return bucketed_sort(words, payloads, counts, stable=stable)
    if plan == "lowmem":
        return chunked_sort(words, payloads, stable=stable)
    raise ValueError(f"unknown plan {plan!r}")
