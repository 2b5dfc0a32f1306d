"""Prefix sums over small count tables.

Port of ``rdst_tpu/ops/prefix.py`` (the reference's ``get_prefix_sums``
and ``get_end_offsets``, sort_utils.rs:10-31).  The tables are tiny
((R,) or (T, R) counts), so ``torch.cumsum`` is all it needs.
"""
from __future__ import annotations

import torch

__all__ = ["exclusive_prefix_sum", "end_offsets"]


def exclusive_prefix_sum(counts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive scan along ``dim``, in ``counts``' own dtype."""
    return torch.cumsum(counts, dim=dim, dtype=counts.dtype) - counts


def end_offsets(counts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive scan along ``dim``: one-past-the-end offsets, in
    ``counts``' own dtype."""
    return torch.cumsum(counts, dim=dim, dtype=counts.dtype)
