"""Plane arithmetic: compares, shifts, complements and the multi-key sort.

Planes are unsigned integer tensors (``torch.uint32``, ``uint16`` or
``uint8``) and keep that storage between stages and at kernel boundaries.
PyTorch implements few operators for UInt16/UInt32/UInt64 (on the CPU: no
``>>``, ``<``, ``max``, ``~``, ``flip``, ``arange`` or ``gather``), so every
plain-code operation on planes goes through this module:

* value arithmetic (compare, shift, mask) runs on int64 upcasts
  (:func:`widen`) and returns to storage through :func:`narrow`, a
  truncating cast that is exact for values in range;
* bit-preserving moves (select, gather, flip, concatenate, complement) run
  on the same-width signed view, which every device implements.

``lex_gt`` ports ``rdst_tpu/ops/pallas_merge.py`` ``_lex_gt`` (and
``rdst_tpu/ops/merge.py`` ``_lex_greater``); ``lex_sort`` stands in for
``jax.lax.sort(operands, num_keys=, is_stable=, dimension=)``.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = [
    "UNSIGNED", "unsigned_of_width", "all_ones", "sview", "widen", "narrow",
    "complement", "where", "take", "flip", "cat", "interleave", "full",
    "arange", "lex_gt", "lex_sort",
]

_SIGNED = {
    torch.uint8: torch.int8,
    torch.uint16: torch.int16,
    torch.uint32: torch.int32,
    torch.uint64: torch.int64,
}
#: Plane storage dtypes.
UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)
_BY_WIDTH = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32}


def unsigned_of_width(nbytes: int) -> torch.dtype:
    return _BY_WIDTH[nbytes]


def all_ones(dtype: torch.dtype) -> int:
    """The plane's own all-ones value (0xFF, 0xFFFF or 0xFFFFFFFF)."""
    return (1 << (dtype.itemsize * 8)) - 1


def sview(p: torch.Tensor) -> torch.Tensor:
    """Same-width signed view of an unsigned plane (other dtypes pass)."""
    s = _SIGNED.get(p.dtype)
    return p if s is None else p.view(s)


def widen(p: torch.Tensor) -> torch.Tensor:
    """Unsigned plane -> int64 holding the same unsigned value.  int64
    tensors pass through, so plain code can keep working values wide."""
    if p.dtype == torch.int64:
        return p
    if p.dtype not in UNSIGNED:
        raise TypeError(f"not an unsigned plane: {p.dtype}")
    return p.view(_SIGNED[p.dtype]).to(torch.int64) & all_ones(p.dtype)


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values -> unsigned ``dtype`` storage, keeping the low bits."""
    return x.to(_SIGNED[dtype]).view(dtype)


def complement(p: torch.Tensor) -> torch.Tensor:
    """XOR with the plane's own all-ones (the JAX package's native ``~``)."""
    return (sview(p) ^ -1).view(p.dtype)


def where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, sview(a), sview(b)).view(a.dtype)


def take(p: torch.Tensor, idx: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Gather along ``dim`` (``idx`` as from ``torch.sort``)."""
    return torch.gather(sview(p), dim, idx).view(p.dtype)


def flip(p: torch.Tensor) -> torch.Tensor:
    return sview(p).flip(0).view(p.dtype)


def cat(ps: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([sview(p) for p in ps]).view(ps[0].dtype)


def interleave(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(m, s) low and high halves -> flat (m, 2, s) order."""
    return torch.stack([sview(lo), sview(hi)], 1).reshape(-1).view(lo.dtype)


def full(n: int, value: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(n,) unsigned plane filled with ``value``."""
    bits = dtype.itemsize * 8
    signed = value - (1 << bits) if value >= 1 << (bits - 1) else value
    return torch.full((n,), signed, dtype=_SIGNED[dtype], device=device).view(
        dtype
    )


def arange(n: int, dtype: torch.dtype = torch.uint32, device=None) -> torch.Tensor:
    return narrow(torch.arange(n, dtype=torch.int64, device=device), dtype)


def lex_gt(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """x > y lexicographically over key planes (most significant first)."""
    gt = torch.zeros(xs[0].shape, dtype=torch.bool, device=xs[0].device)
    eq = torch.ones_like(gt)
    for x, y in zip(xs, ys):
        x, y = widen(x), widen(y)
        gt = gt | (eq & (x > y))
        eq = eq & (x == y)
    return gt


def _packed_groups(keys: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Pack key planes (most significant first) into int64 sort keys.

    Planes group from the least significant end while a group's widths sum
    to at most 64 bits; two u32 words make one group.  Within a group the
    top plane is biased by half its range, so signed int64 order equals
    unsigned lexicographic order and no step overflows.  Groups return most
    significant first."""
    groups: list[list[torch.Tensor]] = []
    bits = 64
    for p in reversed(keys):
        w = p.dtype.itemsize * 8
        if bits + w > 64:
            groups.append([])
            bits = 0
        groups[-1].insert(0, p)
        bits += w
    out = []
    for g in reversed(groups):
        top = g[0]
        v = widen(top) - (1 << (top.dtype.itemsize * 8 - 1))
        for p in g[1:]:
            v = v * (1 << (p.dtype.itemsize * 8)) + widen(p)
        out.append(v)
    return out


def lex_sort(
    planes: Sequence[torch.Tensor],
    num_keys: int,
    stable: bool = False,
    dim: int = -1,
) -> list[torch.Tensor]:
    """Sort ``planes`` along ``dim`` by the first ``num_keys`` (most
    significant first); the rest ride along.

    Keys pack into int64 groups (:func:`_packed_groups`).  One group sorts
    with ``torch.sort``; more chain stable argsorts from the least
    significant group.  Riders follow by gather.  With ``stable=False`` tie
    order is whatever ``torch.sort`` gives, as ``lax.sort(is_stable=False)``
    leaves it to XLA."""
    planes = list(planes)
    groups = _packed_groups(planes[:num_keys])
    if len(groups) == 1:
        _, idx = torch.sort(groups[0], dim=dim, stable=stable)
    else:
        idx = torch.argsort(groups[-1], dim=dim, stable=True)
        for g in reversed(groups[:-1]):
            step = torch.argsort(torch.gather(g, dim, idx), dim=dim, stable=True)
            idx = torch.gather(idx, dim, step)
    return [take(p, idx, dim) for p in planes]
