"""Comparative sort plan: the dense executor.

Port of ``rdst_tpu/sorts/comparative.py``.  Large inputs go to the fused
bitonic executor (``ops/fused_sort.py``, kernels B2 and B3); the rest, and
every shape the executor does not take, to ``lex_sort`` (``torch.sort`` on
packed keys), which takes the place of ``lax.sort``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from rdst_tpu_torch._planes import lex_sort
from rdst_tpu_torch.ops.fused_sort import fused_sort, fused_sort_available

__all__ = ["comparative_sort"]


def comparative_sort(
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor] = (),
    *,
    stable: bool = False,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Sort word planes (most significant first) + payloads."""
    words = list(words)
    payloads = list(payloads)
    if fused_sort_available(words, payloads, stable=stable):
        return fused_sort(words, payloads, stable=stable)
    out = lex_sort(words + payloads, len(words), stable=stable)
    return out[: len(words)], out[len(words):]
