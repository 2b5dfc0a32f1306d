"""Key normalization: map every supported key dtype to sortable uint32 planes.

Port of ``rdst_tpu/keys.py``; the words are bit-equal to the JAX package's
for every dtype.  A key array becomes a tuple of ``torch.uint32`` words,
most significant first, whose ascending lexicographic order is the sort
order:

  * unsigned ints: identity bit pattern
  * signed ints:   ``x ^ MIN`` sign bias
  * floats:        IEEE total-order fold ``s ^= ((s>>31 as u32)>>1); s ^ MIN``
                   (-NaN < -Inf < ... < -0 < +0 < ... < +Inf < +NaN)
  * ``[u8; N]``:   big-endian packing, column 0 most significant
  * composites:    concatenated byte planes, most significant field first

All transforms are exact bit reinterpretations (``Tensor.view``) plus
integer arithmetic on int64 upcasts (``_planes.widen``).  int64's ``>>`` is
arithmetic, so the float fold masks the shifted sign bit.  64-bit numpy
inputs are folded and split into words on the host, as the JAX package
does; 64-bit tensors are split on their device.

Numpy input goes to ``device`` (default ``"cuda"``, which raises when CUDA
is absent); a tensor stays on its own device.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Sequence

import numpy as np
import torch

from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.utils.trace import span, traced

__all__ = [
    "NormalizedKeys",
    "normalize",
    "denormalize",
    "denormalize_host",
    "from_numpy",
    "digit_plane",
    "supported_dtypes",
    "as_device",
    "device_of",
]

_U32 = torch.uint32
_I64_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class NormalizedKeys:
    """A batch of keys normalized to ascending-unsigned uint32 word planes.

    ``words[0]`` is the most significant word.  ``n_bytes`` is the number
    of significant bytes, packed right-aligned (the last word holds byte
    levels 0..3).  ``meta`` records how to invert the transform:
    ``("dtype", torch.dtype) | ("bytes", N) | ("composite", metas)``.
    """

    words: tuple[torch.Tensor, ...]
    n_bytes: int
    meta: tuple

    @property
    def shape(self):
        return self.words[0].shape

    @property
    def n_words(self) -> int:
        return len(self.words)

    def digit(self, level: int, bits: int = 8) -> torch.Tensor:
        return digit_plane(self.words, level, bits)


def as_device(device) -> torch.device:
    """The device numpy input goes to; raises rather than fall back when
    CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but CUDA is not available; "
            "pass device='cpu' to sort on the host"
        )
    return dev


def device_of(arrays, device) -> torch.device:
    """The device of the first tensor among ``arrays``, else the one numpy
    input goes to (:func:`as_device`)."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return as_device(device)


def num_levels(x_or_dtype, *, width: int | None = None) -> int:
    """Number of byte levels of a key dtype (``RadixKey::LEVELS``): a numpy
    or torch dtype, or an array or tensor of one; ``width`` overrides it."""
    dt = getattr(x_or_dtype, "dtype", x_or_dtype)
    n = dt.itemsize if isinstance(dt, torch.dtype) else np.dtype(dt).itemsize
    return n if width is None else width


def supported_dtypes() -> tuple[torch.dtype, ...]:
    return (
        torch.uint8, torch.uint16, torch.uint32, torch.uint64,
        torch.int8, torch.int16, torch.int32, torch.int64,
        torch.float16, torch.float32, torch.float64,
    )


def _digit_i64(words: Sequence[torch.Tensor], level: int, bits: int = 8):
    n_words = len(words)
    widx = n_words - 1 - (level // 4)
    shift = (level % 4) * 8
    if bits == 16 and level % 4 == 3:
        raise ValueError("16-bit digit must not straddle a word boundary")
    if bits not in (8, 16):
        raise ValueError(f"unsupported digit width {bits}")
    return (P.widen(words[widx]) >> shift) & ((1 << bits) - 1)


def digit_plane(words: Sequence[torch.Tensor], level: int, bits: int = 8):
    """8- or 16-bit digit at byte ``level`` (0 = least significant byte of
    the last word), as a uint32 plane."""
    return P.narrow(_digit_i64(words, level, bits), _U32)


# ---------------------------------------------------------------------------
# Forward transforms
# ---------------------------------------------------------------------------


def _split64(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 bit pattern of a u64 value -> (hi, lo) uint32 words (the
    truncating casts keep each word's bits; no masked temporaries)."""
    return P.narrow(u >> 32, _U32), P.narrow(u, _U32)


def _join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 words -> int64 holding the u64 bit pattern: the hi
    word's signed value shifted up, the lo word's unsigned value or-ed in.
    Two int64 temporaries at most, updated in place: at 2^30 keys this is
    the largest transient of a sort's inverse transform."""
    out = P.sview(hi).to(torch.int64)
    out *= 1 << 32  # no overflow: |signed hi| <= 2^31
    low = P.sview(lo).to(torch.int64)
    low &= _M32
    out |= low
    return out


def _float_fold(u: torch.Tensor, nbits: int) -> torch.Tensor:
    """IEEE total-order fold on the unsigned bit pattern, held in int64
    (nbits < 64: the value itself; nbits == 64: the bit pattern)."""
    sign = (u >> (nbits - 1)) & 1
    mask = sign * ((1 << (nbits - 1)) - 1)
    top = _I64_MIN if nbits == 64 else 1 << (nbits - 1)
    return (u ^ mask) ^ top


def _bits_of(x: torch.Tensor) -> torch.Tensor:
    """Unsigned bit pattern of a <= 32-bit tensor, as int64 values."""
    return P.widen(x.view(P.unsigned_of_width(x.dtype.itemsize)))


def _normalize_tensor(x: torch.Tensor) -> tuple[tuple[torch.Tensor, ...], int]:
    dt = x.dtype
    nb = dt.itemsize
    if dt in (torch.uint8, torch.uint16, torch.uint32):
        return (P.narrow(_bits_of(x), _U32),), nb
    if dt in (torch.int8, torch.int16, torch.int32):
        return (P.narrow(x.to(torch.int64) + (1 << (nb * 8 - 1)), _U32),), nb
    if dt == torch.uint64:
        return _split64(x.view(torch.int64)), nb
    if dt == torch.int64:
        return _split64(x ^ _I64_MIN), nb
    if dt in (torch.float16, torch.bfloat16, torch.float32):
        return (P.narrow(_float_fold(_bits_of(x), nb * 8), _U32),), nb
    if dt == torch.float64:
        return _split64(_float_fold(x.view(torch.int64), 64)), nb
    raise TypeError(f"unsupported key dtype {dt}")


def _numpy_u64_words(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side fold/bias of a 64-bit numpy key into (hi, lo) u32 words.
    The split itself is a strided copy of the two 32-bit halves."""
    if not x.dtype.isnative:
        x = x.astype(x.dtype.newbyteorder("="))
    u = np.ascontiguousarray(x).view(np.uint64)
    if x.dtype.kind == "i":
        u = u ^ np.uint64(1 << 63)
    elif x.dtype.kind == "f":
        sign = u >> np.uint64(63)
        u = (u ^ (sign * np.uint64((1 << 63) - 1))) ^ np.uint64(1 << 63)
    halves = u.view(np.uint32).reshape(-1, 2)
    hi, lo = (1, 0) if sys.byteorder == "little" else (0, 1)
    return (np.ascontiguousarray(halves[:, hi]),
            np.ascontiguousarray(halves[:, lo]))


def _normalize_byte_array(x: torch.Tensor) -> tuple[tuple[torch.Tensor, ...], int]:
    """(n, N) uint8 -> lexicographic big-endian words, left zero-padded."""
    if x.ndim != 2 or x.dtype != torch.uint8:
        raise TypeError("byte-array keys must be (n, N) uint8")
    n, nb = x.shape
    n_words = -(-nb // 4)
    pad = n_words * 4 - nb
    cols = x.to(torch.int64)
    if pad:
        cols = torch.cat(
            [torch.zeros((n, pad), dtype=torch.int64, device=x.device), cols], 1
        )
    scale = torch.tensor([1 << 24, 1 << 16, 1 << 8, 1], device=x.device)
    words = (cols.reshape(n, n_words, 4) * scale).sum(-1)
    return tuple(P.narrow(words[:, i].contiguous(), _U32) for i in range(n_words)), nb


def _bf16_tensor(x: np.ndarray, device) -> torch.Tensor:
    """A numpy bfloat16 array as a ``torch.bfloat16`` tensor on ``device``,
    by its bits: the array's dtype needs no import to be read this way."""
    bits = torch.from_numpy(np.ascontiguousarray(x).view(np.int16))
    return _upload(bits, device).view(torch.bfloat16)


def _to_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return _upload(torch.from_numpy(np.ascontiguousarray(x)), device)


def _upload(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor made from numpy, on ``device``: the ``rdst.copy.h2d``
    span."""
    dev = as_device(device)
    with span("copy.h2d"):
        return t.to(dev)


@traced("keys.normalize")
def normalize(x, *, composite: bool = False, device="cuda") -> NormalizedKeys:
    """Normalize a key array (or a sequence of fields, most significant
    first) to word planes.  Numpy input goes to ``device``."""
    if composite or isinstance(x, (list, tuple)):
        return _normalize_composite(tuple(x), device)
    if isinstance(x, np.ndarray):
        if x.ndim == 1 and x.dtype.itemsize == 8 and x.dtype.kind in "uif":
            dev = as_device(device)
            with span("keys.split_host"):
                hi, lo = _numpy_u64_words(x)
            words = tuple(_upload(torch.from_numpy(w), dev) for w in (hi, lo))
            return NormalizedKeys(words, 8, ("dtype", _torch_dtype(x.dtype)))
        if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: kind "V"
            x = _bf16_tensor(x, device)
        elif x.dtype.kind not in "uif" or x.dtype.itemsize > 8:
            raise TypeError(f"unsupported key dtype {x.dtype}")
    t = _to_tensor(x, device)
    if t.ndim == 2 and t.dtype == torch.uint8:
        words, nb = _normalize_byte_array(t)
        return NormalizedKeys(words, nb, ("bytes", t.shape[1]))
    if t.ndim != 1:
        raise ValueError("keys must be 1-D (or (n,N) uint8 byte-array keys)")
    words, nb = _normalize_tensor(t)
    return NormalizedKeys(words, nb, ("dtype", t.dtype))


def _normalize_composite(fields: tuple, device) -> NormalizedKeys:
    parts = [normalize(f, device=device) for f in fields]
    total_bytes = sum(p.n_bytes for p in parts)
    n_words = -(-total_bytes // 4)
    acc = [0] * n_words
    level = total_bytes
    for p in parts:
        for b in reversed(range(p.n_bytes)):  # field's own MSB first
            level -= 1
            widx = n_words - 1 - (level // 4)
            acc[widx] = acc[widx] | (_digit_i64(p.words, b) << ((level % 4) * 8))
    words = tuple(P.narrow(a, _U32) for a in acc)
    metas = tuple((pp.meta, pp.n_bytes) for pp in parts)
    return NormalizedKeys(words, total_bytes, ("composite", metas))


# ---------------------------------------------------------------------------
# Inverse transforms
# ---------------------------------------------------------------------------


def _float_unfold(t: torch.Tensor, nbits: int) -> torch.Tensor:
    """Inverse fold on int64 values (nbits < 64) or bit patterns (64)."""
    if nbits == 64:
        was_negative = t >= 0  # top bit clear
        on, off = -1, _I64_MIN
    else:
        was_negative = (t >> (nbits - 1)) == 0
        on, off = (1 << nbits) - 1, 1 << (nbits - 1)
    mask = torch.where(
        was_negative, torch.full_like(t, on), torch.full_like(t, off)
    )
    return t ^ mask


@traced("keys.denormalize")
def denormalize(nk: NormalizedKeys):
    """Invert :func:`normalize` on the words' device (torch tensors)."""
    return _denormalize_impl(nk.words, nk.n_bytes, nk.meta)


@traced("keys.denormalize")
def denormalize_host(nk: NormalizedKeys, like=None):
    """Invert :func:`normalize` and return numpy arrays on the host.  The
    inverse runs on the words' device and only its result is copied: for
    2^25 u64 keys that took 93 ms against 621 ms for copying the words and
    inverting them on the host CPU (NVIDIA H100 80GB HBM3, 700 W; PERF.md).

    ``like``: the keys as the caller gave them (an array, or a sequence of
    fields).  A bfloat16 key comes back as the numpy dtype of its
    counterpart there (ml_dtypes' bfloat16), its bits viewed as it; numpy
    itself has no bfloat16, so without one it raises ``TypeError``."""
    return _to_numpy(_denormalize_impl(nk.words, nk.n_bytes, nk.meta), like)


def _to_numpy(x, like=None):
    if isinstance(x, tuple):
        likes = like if isinstance(like, (list, tuple)) else (None,) * len(x)
        return tuple(_to_numpy(v, lk) for v, lk in zip(x, likes))
    if x.dtype == torch.bfloat16:
        dt = getattr(like, "dtype", None)
        if not isinstance(dt, np.dtype) or dt.name != "bfloat16":
            raise TypeError("bfloat16 keys have no numpy dtype; use denormalize")
        return _host_copy(x.view(torch.int16)).view(dt)
    return _host_copy(x)


def _host_copy(x: torch.Tensor) -> np.ndarray:
    """``x`` as numpy: the ``rdst.sync.to_numpy`` span."""
    with span("sync.to_numpy"):
        return x.cpu().numpy()


def _denormalize_impl(words, n_bytes: int, meta: tuple):
    kind, info = meta
    if kind == "bytes":
        cols = [
            P.narrow(_digit_i64(words, lvl), torch.uint8)
            for lvl in reversed(range(info))  # most significant = column 0
        ]
        return torch.stack(cols, 1)
    if kind == "composite":
        fields = []
        level = n_bytes
        for sub_meta, nb in info:
            level -= nb
            fw = []
            for w in range(-(-nb // 4)):
                lo_level = level + w * 4
                word = 0
                for b in range(min(4, nb - w * 4)):
                    word = word | (_digit_i64(words, lo_level + b) << (b * 8))
                fw.append(P.narrow(word, _U32))
            fw.reverse()  # most significant first
            fields.append(_denormalize_impl(tuple(fw), nb, sub_meta))
        return tuple(fields)
    dt: torch.dtype = info
    bits = dt.itemsize * 8
    if dt in (torch.uint8, torch.uint16, torch.uint32):
        return P.narrow(P.widen(words[0]), dt)
    if dt in (torch.int8, torch.int16, torch.int32):
        return (P.widen(words[0]) - (1 << (bits - 1))).to(dt)
    if dt == torch.uint64:
        return _join64(words[0], words[1]).view(torch.uint64)
    if dt == torch.int64:
        out = _join64(words[0], words[1])
        out ^= _I64_MIN
        return out
    if dt in (torch.float16, torch.bfloat16, torch.float32):
        ut = P.unsigned_of_width(dt.itemsize)
        return P.narrow(_float_unfold(P.widen(words[0]), bits), ut).view(dt)
    if dt == torch.float64:
        return _float_unfold(_join64(words[0], words[1]), 64).view(torch.float64)
    raise TypeError(f"cannot denormalize {dt}")


# ---------------------------------------------------------------------------
# Carrying keys over from the JAX package
# ---------------------------------------------------------------------------


def _torch_dtype(dt) -> torch.dtype:
    if getattr(dt, "name", str(dt)) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


def _meta_from_numpy(meta: tuple) -> tuple:
    kind, info = meta
    if kind == "dtype":
        return ("dtype", _torch_dtype(info))
    if kind == "composite":
        return ("composite", tuple((_meta_from_numpy(m), nb) for m, nb in info))
    return meta


def from_numpy(words, n_bytes: int, meta: tuple, *, device="cuda") -> NormalizedKeys:
    """The JAX package's ``NormalizedKeys`` (words as numpy uint32 arrays,
    meta with numpy dtypes) as the port's, on ``device``."""
    dev = as_device(device)
    tw = tuple(
        torch.from_numpy(np.array(w, dtype=np.uint32)).to(dev)
        for w in words
    )
    return NormalizedKeys(tw, n_bytes, _meta_from_numpy(meta))
