"""Row-batched sorting primitives: sort / top_k along the last axis.

Port of ``rdst_tpu/ops/rows.py``: many small independent sorts, one per
row, for workloads that are already row-partitioned.  Keys go through the
same normalization as every other path (``keys.py``), so the order
semantics (signed bias, IEEE float total order, composite lexicographic
fields) are those of the flat sorts.  A row sort is ``_planes.lex_sort``
along the last axis (``torch.sort`` on packed int64 keys, in place of
``lax.sort``); a single-word top-k is ``torch.topk`` on an order-preserving
int32 key (in place of ``lax.top_k``).

Numpy input goes to ``device`` (default ``"cuda"``, which raises when CUDA
is absent); a tensor stays on its own device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import keys as _keys

__all__ = ["batched_sort", "batched_top_k"]

_SIGN = -(1 << 31)  # int32 with only the sign bit set


def _is_u8(x) -> bool:
    return x.dtype in (np.uint8, torch.uint8)


def _normalize_rows(x, byte_keys: bool | None = None, device="cuda"):
    """Normalize row-batched keys: flatten (the transforms are elementwise),
    normalize 1-D, reshape the word planes back to the batch shape.

    ``byte_keys`` selects how uint8 input is read: ``True``, the last axis
    holds the bytes of one ``[u8; N]`` lexicographic key (rows run along
    axis -2); ``False``, scalar u8 keys with rows along the last axis;
    ``None``, ``True`` only for uint8 input of 3 or more dimensions (pass
    the flag for batched scalar u8 keys with 2 or more batch dimensions).

    Returns ``(nk with batch-shaped words, batch shape)``."""
    if isinstance(x, (tuple, list)):
        shape = tuple(x[0].shape)
        nk = _keys.normalize(tuple(f.reshape(-1) for f in x), composite=True,
                             device=device)
    else:
        if byte_keys and not _is_u8(x):
            raise TypeError("byte_keys=True requires a uint8 array")
        if byte_keys is None:
            byte_keys = _is_u8(x) and x.ndim >= 3
        if byte_keys:
            shape = tuple(x.shape[:-1])
            nk = _keys.normalize(x.reshape(-1, x.shape[-1]), device=device)
        else:
            shape = tuple(x.shape)
            nk = _keys.normalize(x.reshape(-1), device=device)
    nk = dataclasses.replace(nk, words=tuple(w.reshape(shape) for w in nk.words))
    return nk, shape


def _denormalize_rows(nk: _keys.NormalizedKeys):
    """Invert :func:`_normalize_rows` for (possibly sliced) batch words."""
    out_shape = tuple(nk.words[0].shape)
    flat = dataclasses.replace(nk, words=tuple(w.reshape(-1) for w in nk.words))
    res = _keys.denormalize(flat)
    if isinstance(res, tuple):
        return tuple(f.reshape(out_shape) for f in res)
    if nk.meta[0] == "bytes":
        return res.reshape(out_shape + (nk.meta[1],))
    return res.reshape(out_shape)


def _device_of(x, device) -> torch.device:
    return _keys.device_of(x if isinstance(x, (tuple, list)) else [x], device)


def batched_sort(
    x,
    payloads: Sequence = (),
    *,
    stable: bool = False,
    descending: bool = False,
    byte_keys: bool | None = None,
    device="cuda",
):
    """Sort every row (last axis) of ``x`` independently.

    ``x``: an array of any supported key dtype, or a tuple of arrays (a
    composite key, most significant field first); all shapes ``(..., n)``.
    ``payloads``: arrays of shape ``(..., n)`` permuted alongside their
    row's keys.  ``byte_keys`` reads uint8 input as in
    :func:`_normalize_rows`.

    Returns ``(sorted_keys, [sorted_payloads...])`` as tensors, the keys in
    the input's dtype (a tuple again for composite keys)."""
    dev = _device_of(x, device)
    nk, _ = _normalize_rows(x, byte_keys, dev)
    words = list(nk.words)
    if descending:
        words = [P.complement(w) for w in words]
    operands = words + [_keys._to_tensor(p, dev) for p in payloads]
    out = P.lex_sort(operands, len(words), stable=stable, dim=-1)
    sorted_words = out[: len(words)]
    if descending:
        sorted_words = [P.complement(w) for w in sorted_words]
    sorted_nk = dataclasses.replace(nk, words=tuple(sorted_words))
    return _denormalize_rows(sorted_nk), list(out[len(words):])


def _as_i32_key(w: torch.Tensor, largest: bool) -> torch.Tensor:
    """Order-preserving uint32 -> int32 map (descending top-k order)."""
    if not largest:
        w = P.complement(w)
    return P.sview(w) ^ _SIGN


def _from_i32_key(v: torch.Tensor, largest: bool) -> torch.Tensor:
    w = (v ^ _SIGN).view(torch.uint32)
    return w if largest else P.complement(w)


def batched_top_k(
    x,
    k: int,
    payloads: Sequence = (),
    *,
    largest: bool = True,
    byte_keys: bool | None = None,
    device="cuda",
):
    """Per-row top-``k`` by key order (``largest=False``: bottom-k).

    Single-word keys (dtypes of at most 32 bits) take ``torch.topk`` on an
    order-preserving int32 key; wider and composite keys take a row sort and
    a slice.  Results come in sorted order (descending for
    ``largest=True``).  Among equal keys ``torch.topk`` promises no order,
    so tied payloads may come in another order than the reference's, each
    still beside its own key.  ``byte_keys`` as in :func:`batched_sort`.

    Returns ``(top_keys, [top_payloads...])``, each shaped ``(..., k)``."""
    dev = _device_of(x, device)
    nk, _ = _normalize_rows(x, byte_keys, dev)
    n = nk.words[0].shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for rows of {n}")
    if nk.n_words == 1:
        vals, idx = torch.topk(_as_i32_key(nk.words[0], largest), k, dim=-1)
        sorted_nk = dataclasses.replace(nk, words=(_from_i32_key(vals, largest),))
        outs = [P.take(_keys._to_tensor(p, dev), idx) for p in payloads]
        return _denormalize_rows(sorted_nk), outs
    sorted_keys, outs = batched_sort(
        x, payloads, descending=largest, byte_keys=byte_keys, device=dev
    )
    if isinstance(sorted_keys, tuple):
        sorted_keys = tuple(f[..., :k] for f in sorted_keys)
    else:
        sorted_keys = sorted_keys[..., :k]
    return sorted_keys, [p[..., :k] for p in outs]
