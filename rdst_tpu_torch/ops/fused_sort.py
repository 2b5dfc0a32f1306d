"""Reversal-free fused bitonic sort (kernels B2 and B3).

Port of ``rdst_tpu/ops/pallas_sort.py``; the schedule is the JAX
package's, so the module docstring there explains the design:

  phase 0   rows of ``config.row`` elements sort in one batched
            ``lex_sort``, odd rows on complemented keys (descending), so
            adjacent rows form bitonic pairs with no data movement;
  trip 1    one tail pass un-flips the odd rows on load and runs every merge
            level whose run fits the small block;
  levels    each larger level takes span trips (B3) for the strides at or
            above the big block, then one tail pass (B2) for the rest, with
            odd output runs merging descending so no level reverses data;
  pieces    a length far from a power of two is padded only to a multiple
            of T/16, sorted as power-of-two pieces (odd pieces descending),
            and the pieces merge with virtual-pad bitonic merges.

A uint32 index plane appended as the least significant key makes the order
strict, so ``stable=True`` yields the unique stable permutation.  Unstable
sorts with payloads at padded lengths add a u8 pad marker, which on the
piece path joins only the final piece and the merges after it.  u8/u16
planes stay narrow in device memory and widen to u32 only inside the
kernels.

:func:`tail_call` and :func:`span_call` are the kernel wrappers: CUDA planes
launch ``csrc/bitonic.cu``, CPU planes run :func:`tail_plain` /
:func:`span_plain`, which run the same stage schedule as plain PyTorch.  A
compare-exchange network's output depends only on its stage sequence, so
kernel and plain version agree bit for bit, payloads included.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from rdst_tpu_torch import _build
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config

__all__ = [
    "fused_sort", "fused_sort_available", "pick_blocks", "tail_call",
    "span_call", "tail_plain", "span_plain", "tail_cuda", "span_cuda",
    "TAIL", "SPAN", "MAX_PLANES", "GRAIN",
]

#: Maximum next_pow2(n)/n for padding to the power of two; beyond it the
#: piece-decomposition path pads only to a multiple of T/16.
MAX_PAD_RATIO = 1.13
#: Plane-count ceiling of the kernels (kMaxPlanes in csrc/bitonic.cu).
MAX_PLANES = 8
#: Elements every kernel block and span piece is a multiple of: one warp's
#: worth of 16-byte loads of u32 (32 x 16 B = 128 elements), so span pieces
#: coalesce.  Takes the place of the TPU's 128-lane rows.
GRAIN = 128
_MAX_LEVELS = 32  # kMaxLevels in csrc/bitonic.cu
_SMEM_MAX = 227 * 1024  # bytes of shared memory one CTA may use on sm_90

_PLANE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_int, ctypes.c_longlong]
TAIL = _build.Kernel(
    "bitonic_tail",
    "rdst_bitonic_tail",
    _PLANE_ARGS + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
SPAN = _build.Kernel(
    "bitonic_span",
    "rdst_bitonic_span",
    _PLANE_ARGS + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p],
)


def _log2(x: int) -> int:
    return int(x).bit_length() - 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def pick_blocks(n_planes: int) -> tuple[int, int]:
    """(small, big) shared-memory blocks (elements) for ``n_planes``.

    The largest power of two whose planes, widened to 4 bytes, fit
    ``config.bitonic_smem_bytes``.  On the TPU the multi-level trip-1 kernel
    needed a smaller block than the single-level sweeps (scoped-VMEM
    stack); a CTA has no such extra cost, so both are the same here."""
    cap = config.bitonic_smem_bytes // (4 * max(n_planes, 1))
    big = 1 << _log2(max(cap, 2 * GRAIN))
    return big, big


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _ones_mask(dtypes, n_keys):
    return [P.all_ones(dt) if j < n_keys else 0 for j, dt in enumerate(dtypes)]


def _stages_plain(v, ones, strides, desc):
    """Ascending compare-exchange stages over int64 planes ``v`` at
    ``strides``; where ``desc`` is set the key planes (``ones[j]`` != 0)
    are complemented around them, which makes those runs descending."""
    n_keys = sum(1 for o in ones if o)
    v = [torch.where(desc, x ^ o, x) if o else x for x, o in zip(v, ones)]
    n = v[0].shape[0]
    for s in strides:
        halves = [x.view(n // (2 * s), 2, s) for x in v]
        lo = [h[:, 0] for h in halves]
        hi = [h[:, 1] for h in halves]
        swap = P.lex_gt(lo[:n_keys], hi[:n_keys])
        v = [
            torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)], 1)
            .reshape(n)
            for a, b in zip(lo, hi)
        ]
    return [torch.where(desc, x ^ o, x) if o else x for x, o in zip(v, ones)]


def _strides(hi: int, lo: int = 1) -> list[int]:
    out = []
    s = hi
    while s >= lo:
        out.append(s)
        s //= 2
    return out


def _check_planes(planes, n, n_keys):
    if not 1 <= n_keys <= len(planes) <= MAX_PLANES:
        raise ValueError("1 <= n_keys <= planes <= MAX_PLANES")
    for p in planes:
        if p.dtype not in P.UNSIGNED or p.shape != (n,):
            raise ValueError("kernel planes must be (n,) u8/u16/u32")


def _check_tail(planes, n, block, n_keys, levels):
    _check_planes(planes, n, n_keys)
    if block < 2 or block & (block - 1) or n % block:
        raise ValueError(f"tail block {block} must be a power of two dividing {n}")
    if len(levels) > _MAX_LEVELS:
        raise ValueError("too many levels for one tail pass")
    for _, start in levels:
        if start < 1 or start & (start - 1) or start > block // 2:
            raise ValueError(f"level start {start} outside the block")


def tail_plain(planes, n, block, n_keys, levels, unflip_shift):
    """Plain PyTorch version of the tail kernel (same stage schedule)."""
    _check_tail(planes, n, block, n_keys, levels)
    TAIL.plain_calls += 1
    dtypes = [p.dtype for p in planes]
    ones = _ones_mask(dtypes, n_keys)
    v = [P.widen(p) for p in planes]
    gid = torch.arange(n, device=planes[0].device)
    if unflip_shift is not None:
        flip = ((gid >> unflip_shift) & 1) == 1
        v = [torch.where(flip, x ^ o, x) if o else x for x, o in zip(v, ones)]
    for log_2r, start in levels:
        desc = ((gid >> log_2r) & 1) == 1
        v = _stages_plain(v, ones, _strides(start), desc)
    return [P.narrow(x, dt) for x, dt in zip(v, dtypes)]


def _span_geometry(n, s_hi, s_lo, two_r, block):
    p_dim = (2 * s_hi) // s_lo
    for x in (s_hi, s_lo, block, two_r):
        if x < 1 or x & (x - 1):
            raise ValueError("span sizes must be powers of two")
    if s_lo > s_hi or p_dim > block or block // p_dim > s_lo:
        raise ValueError(f"bad span geometry s_hi={s_hi} s_lo={s_lo} block={block}")
    if n % (2 * s_hi) or two_r < 2 * s_hi:
        raise ValueError("span cells must tile n and sit inside one run")
    return p_dim


def span_plain(planes, n, s_hi, s_lo, two_r, block, n_keys):
    """Plain PyTorch version of the span kernel: the stages at strides
    s_hi .. s_lo, descending in odd runs of length ``two_r``."""
    _span_geometry(n, s_hi, s_lo, two_r, block)
    _check_planes(planes, n, n_keys)
    SPAN.plain_calls += 1
    dtypes = [p.dtype for p in planes]
    gid = torch.arange(n, device=planes[0].device)
    desc = ((gid >> _log2(two_r)) & 1) == 1
    v = _stages_plain([P.widen(p) for p in planes], _ones_mask(dtypes, n_keys),
                      _strides(s_hi, s_lo), desc)
    return [P.narrow(x, dt) for x, dt in zip(v, dtypes)]


def _plane_ptrs(planes):
    outs = [torch.empty_like(p) for p in planes]
    k = len(planes)
    ins_a = (ctypes.c_void_p * k)(*[p.data_ptr() for p in planes])
    outs_a = (ctypes.c_void_p * k)(*[p.data_ptr() for p in outs])
    widths = (ctypes.c_int * k)(*[p.dtype.itemsize for p in planes])
    return outs, ins_a, outs_a, widths


def _check_smem(block, n_planes):
    if block * n_planes * 4 > _SMEM_MAX:
        raise ValueError(
            f"block {block} x {n_planes} planes exceeds a CTA's shared memory"
        )


def tail_cuda(planes, n, block, n_keys, levels, unflip_shift):
    """Launch the tail kernel of ``csrc/bitonic.cu``."""
    planes = [p.contiguous() for p in planes]
    _check_tail(planes, n, block, n_keys, levels)
    dev, _ = _build.check_cuda_planes(planes, P.UNSIGNED)
    _check_smem(block, len(planes))
    outs, ins_a, outs_a, widths = _plane_ptrs(planes)
    log_2r = (ctypes.c_int * _MAX_LEVELS)(*[l for l, _ in levels])
    starts = (ctypes.c_int * _MAX_LEVELS)(*[s for _, s in levels])
    TAIL.launch(
        dev, ins_a, outs_a, widths, len(planes), n_keys, n, block, log_2r,
        starts, len(levels), -1 if unflip_shift is None else unflip_shift,
        _build.stream_of(planes[0]),
    )
    return outs


def span_cuda(planes, n, s_hi, s_lo, two_r, block, n_keys):
    """Launch the span kernel of ``csrc/bitonic.cu``."""
    planes = [p.contiguous() for p in planes]
    _span_geometry(n, s_hi, s_lo, two_r, block)
    _check_planes(planes, n, n_keys)
    dev, _ = _build.check_cuda_planes(planes, P.UNSIGNED)
    _check_smem(block, len(planes))
    outs, ins_a, outs_a, widths = _plane_ptrs(planes)
    SPAN.launch(
        dev, ins_a, outs_a, widths, len(planes), n_keys, n, s_hi, s_lo,
        block, _log2(two_r // (2 * s_hi)), _build.stream_of(planes[0]),
    )
    return outs


def _on_cuda(planes) -> bool:
    dev = planes[0].device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"no bitonic kernels for device {planes[0].device}")
    return dev == "cuda"


def tail_call(planes, n, block, n_keys, levels, unflip_shift):
    """B2: run ``levels`` (each ``(log2(2R), start_stride)``) on every
    aligned ``block``; the kernel for CUDA planes, the plain version for
    CPU planes."""
    fn = tail_cuda if _on_cuda(planes) else tail_plain
    return fn(list(planes), n, block, n_keys, list(levels), unflip_shift)


def span_call(planes, n, s_hi, s_lo, two_r, block, n_keys):
    """B3: the stages at strides ``s_hi .. s_lo`` in one trip; the kernel
    for CUDA planes, the plain version for CPU planes."""
    fn = span_cuda if _on_cuda(planes) else span_plain
    return fn(list(planes), n, s_hi, s_lo, two_r, block, n_keys)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def _norm_plane(p: torch.Tensor) -> tuple[torch.Tensor, Callable]:
    """View a plane as the same-width unsigned integer; return the
    restoring inverse.  u8/u16 planes stay narrow."""
    target = P.unsigned_of_width(p.dtype.itemsize)
    if p.dtype == target:
        return p, lambda q: q
    dt = p.dtype
    return p.view(target), lambda q: q.view(dt)


def fused_sort_available(
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor] = (),
    *,
    stable: bool = False,
) -> bool:
    """True when the fused executor can and should take this sort.

    The size and shape rules of ``pallas_sort.fused_sort_available``: at
    least ``config.fused_min_elems`` elements, unsigned key planes of at
    most 32 bits, non-bool payloads of at most 32 bits, and at most
    MAX_PLANES planes counting the index plane and a pad marker.  The device
    is not part of the gate: the kernel wrappers decide by it."""
    n = int(words[0].shape[0])
    if n < config.fused_min_elems:
        return False
    if any(p.dtype not in P.UNSIGNED for p in words):
        return False
    for p in payloads:
        if p.dtype == torch.bool or p.dtype.is_complex or p.dtype.itemsize > 4:
            return False
        if p.dtype.is_floating_point and p.dtype.itemsize < 2:
            return False
    return len(words) + len(payloads) + 2 <= MAX_PLANES


def fused_sort(
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor] = (),
    *,
    stable: bool = False,
    row: int | None = None,
    block: int | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Sort key word planes (most significant first) + payload planes.

    ``row`` and ``block`` override the phase-0 row length and the small
    block (tests use them to run every kernel shape at small n)."""
    words = list(words)
    payloads = list(payloads)
    for p in words:
        if p.dtype not in P.UNSIGNED:
            raise TypeError(f"fused_sort keys must be unsigned planes, got {p.dtype}")
    n = int(words[0].shape[0])
    nk = len(words)
    dev = words[0].device

    wk = [_norm_plane(p) for p in words]
    wp = [_norm_plane(p) for p in payloads]
    kplanes = [p for p, _ in wk]
    pplanes = [p for p, _ in wp]

    T = _next_pow2(n)
    if T <= MAX_PAD_RATIO * n or T < (1 << 12):
        total, Q = T, None
    else:
        Q = T // 16
        total = -(-n // Q) * Q
        if total == T:
            Q = None
    pad = total - n
    if pad:
        kplanes = [
            P.cat([p, P.full(pad, P.all_ones(p.dtype), p.dtype, dev)])
            for p in kplanes
        ]
    planes = list(kplanes)
    n_keys = nk
    late_marker = False
    if stable:
        planes.append(P.arange(total, torch.uint32, dev))
        n_keys += 1
    elif pad and pplanes:
        if Q is None:
            planes.append(P.cat([
                P.full(n, 0, torch.uint8, dev), P.full(pad, 1, torch.uint8, dev)
            ]))
            n_keys += 1
        else:
            late_marker = True
    if pad:
        pplanes = [P.cat([p, P.full(pad, 0, p.dtype, dev)]) for p in pplanes]
    planes += pplanes

    def finish(out):
        out = [p[:n] for p in out] if pad else list(out)
        if n_keys > nk:
            out = out[:nk] + out[nk + 1:]
        return (
            [r(p) for p, (_, r) in zip(out[:nk], wk)],
            [r(p) for p, (_, r) in zip(out[nk:], wp)],
        )

    if block is not None:
        blk_s = block
        blk_b = min(
            block * (4 if len(planes) == 1 else 2),
            pick_blocks(len(planes))[1],
        )
        blk_b = max(blk_b, blk_s)
    else:
        blk_s, blk_b = pick_blocks(len(planes) + (1 if late_marker else 0))
    m = min(row or config.row, min(blk_s, total) // 2)
    if total < 2 * GRAIN or m < 2 or min(blk_s, total) < 2 * GRAIN:
        return finish(P.lex_sort(planes, n_keys, stable=False))

    if Q is None:
        return finish(_core(planes, total, n_keys, blk_s, blk_b, m))

    M = total // Q
    pieces = []
    off = 0
    for bit in range(M.bit_length() - 1, -1, -1):
        if M & (1 << bit):
            pieces.append((off, (1 << bit) * Q))
            off += (1 << bit) * Q
    acc = _sort_piece(
        [p[: pieces[0][1]] for p in planes], n_keys, False, blk_s, blk_b, m
    )
    la = pieces[0][1]
    for o, ln in pieces[1:]:
        sub = [p[o: o + ln] for p in planes]
        nk_piece = n_keys
        if late_marker and o + ln == total:
            # pads (global positions >= n) are all inside this piece
            marker = P.cat([P.full(n - o, 0, torch.uint8, dev),
                            P.full(total - n, 1, torch.uint8, dev)])
            sub = sub[:n_keys] + [marker] + sub[n_keys:]
            nk_piece += 1
        pc = _sort_piece(sub, nk_piece, True, blk_s, blk_b, m)
        if nk_piece != n_keys:
            acc = acc[:n_keys] + [P.full(la, 0, torch.uint8, dev)] + acc[n_keys:]
            n_keys = nk_piece
        acc = [P.cat([a, b]) for a, b in zip(acc, pc)]
        la += ln
        acc = _merge_asc_desc(acc, la, Q, n_keys, blk_b)
    return finish(acc)


def _core(planes, T, n_keys, blk_s, blk_b, m):
    """The power-of-two network: phase-0 rows, trip 1, then per level span
    trips for strides >= blk_b and one tail sweep."""
    blk_s = min(blk_s, T)
    blk_b = min(blk_b, T)
    m = min(m, blk_s // 2)
    log_m, log_bs, log_bb, log_t = (
        _log2(m), _log2(blk_s), _log2(blk_b), _log2(T),
    )
    dev = planes[0].device

    # phase 0: alternating-direction rows in one batched sort
    gid = torch.arange(T, device=dev)
    flip = ((gid >> log_m) & 1) == 1
    planes = [
        P.where(flip, P.complement(p), p) if j < n_keys else p
        for j, p in enumerate(planes)
    ]
    rows = P.lex_sort([p.reshape(T // m, m) for p in planes], n_keys, dim=1)
    planes = [p.reshape(T) for p in rows]

    # trip 1: un-flip + every level up to run length blk_s
    levels = [(l2r, 1 << (l2r - 1)) for l2r in range(log_m + 1, log_bs + 1)]
    planes = tail_call(planes, T, blk_s, n_keys, levels, unflip_shift=log_m)

    # larger levels: span trips for strides R..blk_b, then one tail sweep.
    # The span fan-in keeps pieces at least GRAIN elements long.
    max_span = max(1, _log2(blk_b // GRAIN))
    for log_r in range(log_bs, log_t):
        two_r = 1 << (log_r + 1)
        hi = log_r
        while hi >= log_bb:
            lo = max(log_bb, hi - max_span + 1)
            planes = span_call(planes, T, 1 << hi, 1 << lo, two_r, blk_b, n_keys)
            hi = lo - 1
        planes = tail_call(
            planes, T, blk_b, n_keys,
            [(log_r + 1, min(blk_b // 2, 1 << log_r))], None,
        )
    return planes


def _sort_piece(planes, n_keys, descending, blk_s, blk_b, m):
    """Sort one power-of-two piece; ``descending`` complements the keys
    around an ascending sort."""
    ln = int(planes[0].shape[0])
    if descending:
        planes = [P.complement(p) if j < n_keys else p for j, p in enumerate(planes)]
    if ln >= config.fused_min_piece and min(blk_s, ln) >= 2 * GRAIN and m >= 2:
        out = _core(list(planes), ln, n_keys, blk_s, blk_b, m)
    else:
        out = P.lex_sort(planes, n_keys, stable=False)
    if descending:
        out = [P.complement(p) if j < n_keys else p for j, p in enumerate(out)]
    return out


def _stage_ranges(s: int, p: int, nR: int) -> list[tuple[int, int]]:
    """Active index runs of one virtual-pad merge stage, in real
    coordinates: ``{j in [0, nR-s) : ((j+p) & s) == 0}`` as [start, end)."""
    out = []
    x = (p // (2 * s)) * (2 * s)
    while x < p + nR - s:
        lo = max(x - p, 0)
        hi = min(x + s - p, nR - s)
        if hi > lo:
            out.append((lo, hi))
        x += 2 * s
    return out


def _slice_stage(planes, n_keys, s, p, nR):
    """One ascending stage at stride ``s`` of the virtual-pad merge, as
    contiguous slices + select + concatenate."""
    ranges = _stage_ranges(s, p, nR)
    if not ranges:
        return planes
    segs = [[] for _ in planes]
    pos = 0
    for a, b in ranges:
        lo = [pl[a:b] for pl in planes]
        hi = [pl[a + s: b + s] for pl in planes]
        swap = P.lex_gt(lo[:n_keys], hi[:n_keys])
        for i, pl in enumerate(planes):
            if pos < a:
                segs[i].append(pl[pos:a])
            segs[i].append(P.where(swap, hi[i], lo[i]))
            if b < a + s:
                segs[i].append(pl[b: a + s])
            segs[i].append(P.where(swap, lo[i], hi[i]))
        pos = b + s
    for i, pl in enumerate(planes):
        if pos < nR:
            segs[i].append(pl[pos:nR])
    return [P.cat(sg) if len(sg) > 1 else sg[0] for sg in segs]


def _merge_asc_desc(planes, nR, Q, n_keys, blk):
    """Ascending bitonic merge of [run A asc, run B desc] (total nR, a
    multiple of Q): virtual -inf pads in front make it a power-of-two
    bitonic sequence; stages with stride >= Q run as slice stages, the rest
    through the span and tail kernels."""
    T = _next_pow2(nR)
    p = T - nR
    s = T // 2
    while s >= Q:
        planes = _slice_stage(planes, n_keys, s, p, nR)
        s //= 2
    blk_m = min(blk, Q)
    log_b = _log2(blk_m)
    max_span = max(1, _log2(max(blk_m // GRAIN, 2)))
    hi = _log2(Q) - 1
    while hi >= log_b:
        lo = max(log_b, hi - max_span + 1)
        planes = span_call(planes, nR, 1 << hi, 1 << lo, 2 * T, blk_m, n_keys)
        hi = lo - 1
    start = min(blk_m, Q) // 2
    return tail_call(planes, nR, blk_m, n_keys, [(_log2(T) + 1, start)], None)
