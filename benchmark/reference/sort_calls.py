"""The key pools of the sort cells and the plain reference of the sort:
plain torch and numpy, independent of the program (this file imports
nothing of it).

``reference`` sorts u64 keys with ``torch.sort`` (as int64 with the top
bit flipped, which orders them as unsigned).  ``top32_order`` is the
control: the keys ordered by their top 32 bits only, stably, as a sort
that skipped the low digits would.
"""
from __future__ import annotations

import numpy as np
import torch

_TOP = -(1 << 63)


def device_pool(n, count, seed, dev):
    """``count`` arrays of n u64 keys, every bit uniform, made on ``dev``
    from the seed in one call."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randint(0, 1 << 32, (count, 2, n), generator=gen, device=dev,
                      dtype=torch.int64)
    keys = (h[:, 0] << 32) | h[:, 1]
    del h
    return [k.view(torch.uint64) for k in keys.unbind(0)]


def host_pool(n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False)
            for _ in range(count)]


def reference(keys: torch.Tensor) -> torch.Tensor:
    """``keys`` (u64, as int64 bits) in ascending unsigned order."""
    flipped = keys.view(torch.int64) ^ _TOP
    return torch.sort(flipped).values ^ _TOP


def top32_order(keys: torch.Tensor) -> torch.Tensor:
    """``keys`` (u64) ordered by their top 32 bits alone, stably."""
    signed = keys.view(torch.int64)
    top = (signed >> 32) & 0xFFFFFFFF  # the top 32 bits, as unsigned
    return signed[torch.sort(top, stable=True).indices].view(torch.uint64)
