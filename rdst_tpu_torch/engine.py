"""Static-plan sort entry point over word planes.

Port of ``rdst_tpu/engine.py``.  ``sort_words`` runs a plan chosen by name,
with no tuner:

  auto         - packed level compaction when ``counts`` are given,
                 else the comparative executor
  comparative  - ``sorts/comparative.py`` (fused bitonic / ``lex_sort``)
  packed       - force level compaction (requires ``counts``)

``bucketed`` (ROADMAP A7) and ``lowmem`` (ROADMAP A6) are not ported yet
and raise.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch.sorts.comparative import comparative_sort
from rdst_tpu_torch.sorts.lsb import packed_sort

__all__ = ["sort_words"]

_NOT_PORTED = {"bucketed": "ROADMAP A7", "lowmem": "ROADMAP A6"}


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
    if plan in _NOT_PORTED:
        raise NotImplementedError(f"plan={plan!r}: {_NOT_PORTED[plan]}")
    raise ValueError(f"unknown plan {plan!r}")
