"""Public sorting API: ``RadixSortBuilder`` and the convenience functions.

Port of ``rdst_tpu/builder.py`` with torch tensors in place of jax arrays:

    y = radix_sort_unstable(x)
    y = radix_sort_builder(x).with_low_mem_tuner().sort()
    keys, vals = sort_key_value(k, v, stable=True)
    idx = argsort(x)

Numpy input goes to ``device`` (default ``"cuda"``; raises when CUDA is
absent) and comes back as numpy, from the card in page-locked host memory
(``keys._host_copy``); a tensor sorts on its own device and comes back as
tensors there.  A small 1-D numpy input (at most
``config.host_sort_max`` elements, under a built-in tuner) sorts on the C++
host runtime instead (``_try_host_sort``, ``native/host.py``), as in the JAX
package; the limit is 0 by default, since the card was faster at every size
measured (``config.py``).  The device is resolved first all the same, so
``device="cuda"`` without CUDA raises at every size.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch import keys as _keys
from rdst_tpu_torch.sorter import Sorter
from rdst_tpu_torch.tuner import (
    Algorithm,
    LowMemoryTuner,
    SingleAlgoTuner,
    SingleThreadedTuner,
    StandardTuner,
    Tuner,
)
from rdst_tpu_torch.utils.trace import traced

__all__ = [
    "RadixSortBuilder",
    "radix_sort_unstable",
    "radix_sort_builder",
    "sort_key_value",
    "argsort",
]


class RadixSortBuilder:
    """Fluent sort configuration (reference: radix_sort_builder.rs:13-157)."""

    def __init__(self, data, payloads: Sequence = (), *, device="cuda"):
        self._data = data
        self._payloads = list(payloads)
        self._device = device
        self._parallel = True
        self._tuner: Tuner = StandardTuner()
        self._stable = False

    def with_parallel(self, parallel: bool) -> "RadixSortBuilder":
        """Single-program mode: the tuner's picks map onto the reduced
        single-threaded Algorithm set (radix_sort_builder.rs:53-57)."""
        self._parallel = parallel
        return self

    def with_low_mem_tuner(self) -> "RadixSortBuilder":
        self._tuner = LowMemoryTuner()
        return self

    def with_single_threaded_tuner(self) -> "RadixSortBuilder":
        self._tuner = SingleThreadedTuner()
        return self

    def with_tuner(self, tuner: Tuner) -> "RadixSortBuilder":
        self._tuner = tuner
        return self

    def with_stable(self, stable: bool = True) -> "RadixSortBuilder":
        """Stable ordering (only matters with payloads)."""
        self._stable = stable
        return self

    def with_algorithm(self, algorithm: Algorithm) -> "RadixSortBuilder":
        """Pin one algorithm (SingleAlgoTuner, test_utils.rs:40-49)."""
        self._tuner = SingleAlgoTuner(algorithm)
        return self

    def _sort_device(self) -> torch.device:
        """A tensor's own device, else the requested one for numpy."""
        fields = self._data if isinstance(self._data, (list, tuple)) else [self._data]
        return _keys.device_of(list(fields) + self._payloads, self._device)

    def _try_host_sort(self, n: int):
        """The host path for small numpy inputs (``rdst_tpu/builder.py``
        ``_try_host_sort``): the C++ runtime sorts them without a round trip
        to the card, with the same normalization.  Only the built-in tuners
        route here (a forced Algorithm or a custom tuner is a request for the
        device plans).  The device is resolved first, so a request for an
        absent card raises here too.  Returns the result, or None to go on
        to the device."""
        from rdst_tpu_torch.native import host as _host

        self._sort_device()
        if n > config.host_sort_max or config.host_sort_max <= 0:
            return None
        if type(self._tuner) not in (
            StandardTuner, LowMemoryTuner, SingleThreadedTuner
        ):
            return None
        data = self._data
        if not isinstance(data, np.ndarray) or data.ndim != 1:
            return None
        dt = data.dtype
        if dt.kind not in "uif" or dt.itemsize > 8:
            return None
        if not all(
            isinstance(p, np.ndarray) and p.ndim == 1 and p.dtype.itemsize <= 4
            for p in self._payloads
        ):
            return None

        u = _host_fold(data)  # a new array: the host sort is in place
        if len(self._payloads) == 1 and self._payloads[0].dtype.itemsize == 4:
            pw = self._payloads[0].view(np.uint32).copy()
            _host.host_radix_sort(u, pw)
            out_payloads = (pw.view(self._payloads[0].dtype),)
        elif self._payloads:
            order = np.arange(n, dtype=np.uint32)
            _host.host_radix_sort(u, order)
            out_payloads = tuple(p[order] for p in self._payloads)
        else:
            _host.host_radix_sort(u)
            out_payloads = ()
        keys_out = _host_unfold(u, dt)
        if self._payloads:
            return keys_out, out_payloads
        return keys_out

    @traced("sort")
    def sort(self):
        """Run the sort; returns sorted keys (and payloads if provided).
        The whole call is the ``rdst.sort`` span (``utils.trace``)."""
        data = self._data
        fields = data if isinstance(data, (list, tuple)) else [data]
        want_numpy = any(isinstance(f, np.ndarray) for f in fields)
        n = _length_of(data)
        if n <= 1:
            # early-out (radix_sort_builder.rs:150-152)
            if self._payloads:
                return data, tuple(self._payloads)
            return data

        host = self._try_host_sort(n)
        if host is not None:
            return host
        dev = self._sort_device()
        nk = _keys.normalize(data, device=dev)
        payload_info = [
            _encode_payload(p, dev, allow_narrow=True) for p in self._payloads
        ]
        payload_words = [w for info in payload_info for w in info[0]]

        sorter = Sorter(parallel=self._parallel, tuner=self._tuner)
        out_nk, out_payload_words = sorter.run(
            nk, payload_words, stable=self._stable
        )
        # let the input planes go before the inverse transform: at the
        # largest sizes its temporaries are the call's peak device memory
        decoders = [(len(words), decode) for words, decode in payload_info]
        del nk, payload_words, payload_info
        if want_numpy:
            sorted_keys = _keys.denormalize_host(out_nk, like=data)
        else:
            sorted_keys = _keys.denormalize(out_nk)
        if not self._payloads:
            return sorted_keys
        out_payloads = []
        i = 0
        for k, decode in decoders:
            out_payloads.append(decode(out_payload_words[i: i + k]))
            i += k
        if want_numpy:
            out_payloads = [_keys._host_copy(p) for p in out_payloads]
        return sorted_keys, tuple(out_payloads)


def _host_fold(data: np.ndarray) -> np.ndarray:
    """A 1-D numpy key as a new u32 (up to 4 bytes) or u64 array whose
    unsigned order is the key's: signed keys with the sign bit flipped,
    floats folded to IEEE total order by :func:`keys._float_fold`."""
    dt = data.dtype
    bits = dt.itemsize * 8
    wide = np.uint64 if bits == 64 else np.uint32
    if dt.kind == "u":
        return data.astype(wide)
    t = torch.from_numpy(np.ascontiguousarray(data))
    if dt.kind == "i":
        v = t.to(torch.int64) + (1 << (bits - 1)) if bits < 64 else t ^ _keys._I64_MIN
    elif bits < 64:
        v = _keys._float_fold(_keys._bits_of(t), bits)
    else:
        v = _keys._float_fold(t.view(torch.int64), 64)
    v = v.numpy()
    return v.view(np.uint64) if bits == 64 else v.astype(np.uint32)


def _host_unfold(u: np.ndarray, dt: np.dtype) -> np.ndarray:
    """Invert :func:`_host_fold` into an array of dtype ``dt``."""
    bits = dt.itemsize * 8
    if dt.kind == "u":
        return u.astype(dt)
    t = torch.from_numpy(u.view(np.int64) if bits == 64 else u.astype(np.int64))
    if dt.kind == "i":
        v = t - (1 << (bits - 1)) if bits < 64 else t ^ _keys._I64_MIN
        return v.numpy().astype(dt)
    v = _keys._float_unfold(t, bits).numpy()
    if bits == 64:
        return v.view(dt)
    return v.astype(f"uint{bits}").view(dt)


def _length_of(data) -> int:
    if isinstance(data, (list, tuple)):
        return int(data[0].shape[0])
    return int(data.shape[0])


def _encode_payload(p, device: torch.device, *, allow_narrow: bool = False):
    """Encode a payload array as word planes + decoder.

    Payloads ride the sort as opaque words: 8-byte types as (hi, lo) u32,
    bool as u32, the rest bit-cast to their own width and widened to u32,
    or to u16 when ``allow_narrow`` and at most 16 bits (a rider's cost is
    proportional to its width)."""
    if isinstance(p, (list, tuple)):
        raise TypeError("payload must be a single array")
    t = p if isinstance(p, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(p)
    )
    t = t.to(device)
    dt = t.dtype
    if dt == torch.bool:
        return (P.narrow(t.to(torch.int64), torch.uint32),), (
            lambda ws: P.sview(ws[0]) != 0
        )
    if dt.is_complex or dt.itemsize not in (1, 2, 4, 8):
        raise TypeError(f"unsupported payload dtype {dt}")
    if dt.itemsize == 8:
        hi, lo = _keys._split64(t.view(torch.int64))

        def decode64(ws, dt=dt):
            return _keys._join64(ws[0], ws[1]).view(dt)

        return (hi, lo), decode64
    up = P.unsigned_of_width(dt.itemsize)
    ride = torch.uint16 if (allow_narrow and dt.itemsize <= 2) else torch.uint32
    w = P.narrow(P.widen(t.view(up)), ride)

    def decode32(ws, dt=dt, up=up):
        return P.narrow(P.widen(ws[0]), up).view(dt)

    return (w,), decode32


# ---------------------------------------------------------------------------
# module-level convenience API
# ---------------------------------------------------------------------------


def radix_sort_unstable(data, *, device="cuda"):
    """Sorted copy with the default (Standard) tuner."""
    return RadixSortBuilder(data, device=device).sort()


def radix_sort_builder(data, payloads: Sequence = (), *, device="cuda"):
    return RadixSortBuilder(data, payloads, device=device)


def sort_key_value(keys_arr, values, *, stable: bool = False, device="cuda"):
    """Sort (key, value) pairs.  ``values`` may be one array or a sequence."""
    multi = isinstance(values, (list, tuple))
    vals = list(values) if multi else [values]
    k, vs = (
        RadixSortBuilder(keys_arr, vals, device=device).with_stable(stable).sort()
    )
    return (k, vs) if multi else (k, vs[0])


def argsort(keys_arr, *, stable: bool = True, device="cuda"):
    """Indices (uint32) that sort ``keys_arr``, stable by default.

    Stable mode sorts the composite key (key, index) unstably: the index
    field makes the order strict, so the unique result is the stable
    permutation and the index field comes back as the answer."""
    n = _length_of(keys_arr)
    fields = list(keys_arr) if isinstance(keys_arr, (list, tuple)) else [keys_arr]
    tensors = [f for f in fields if isinstance(f, torch.Tensor)]
    if tensors:
        idx = P.arange(n, torch.uint32, tensors[0].device)
    else:
        idx = np.arange(n, dtype=np.uint32)
    if not stable:
        _, out = sort_key_value(keys_arr, idx, stable=False, device=device)
        return out
    if len(fields) == 1 and isinstance(fields[0], np.ndarray):
        # a small single-key numpy input takes the host path: the host LSD
        # radix sort is stable, so key + index payload is the permutation
        host = RadixSortBuilder(fields[0], [idx], device=device)._try_host_sort(n)
        if host is not None:
            return host[1][0]
    out = RadixSortBuilder(tuple(fields + [idx]), device=device).sort()
    return out[-1]
