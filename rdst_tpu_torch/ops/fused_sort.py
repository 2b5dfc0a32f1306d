"""The fused executor: LSD radix passes (B8) or the reversal-free bitonic
network (kernels B2 and B3).

Rows whose key planes sum to at most 8 bytes, with at most one payload plane
of at most 4 bytes, sort by one stable radix pass per key byte
(``ops/radix_sort.py``, kernel B8, digit bases from B1): no phase 0, no pad,
no network, no piece merge and no index plane.  Every wider row takes the
network, a port of ``rdst_tpu/ops/pallas_sort.py``; its schedule is the JAX
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
            of T/16 and sorted as ascending power-of-two pieces, each merged
            into the run of the pieces before it in one pass (B7,
            :func:`piece_merge`); the JAX package merges them with
            virtual-pad bitonic merges instead.

A uint32 index plane appended as the least significant key makes the order
strict, so ``stable=True`` yields the unique stable permutation.  Unstable
sorts with payloads at padded lengths add a u8 pad marker, which on the
piece path joins only the final piece and the merge after it.  u8/u16
planes stay narrow in device memory and widen to u32 only inside the
kernels.

:func:`tail_call` and :func:`span_call` are the kernel wrappers: CUDA planes
launch ``csrc/bitonic.cu``, CPU planes run :func:`tail_plain` /
:func:`span_plain`, which run the same stage schedule as plain PyTorch.  A
compare-exchange network's output depends only on its stage sequence, so
kernel and plain version agree bit for bit, payloads included.  The kernels
hold a tile in registers; :func:`_net_plan` turns a launch's stages into the
steps the kernel runs (compare-exchanges between registers or lanes, and
the moves between register layouts that the other strides need).
:func:`piece_merge` launches ``csrc/piece_merge.cu`` for CUDA planes and
runs :func:`piece_merge_plain`, a stable sort of the concatenation, for CPU
planes; a stable merge has one output, so the two agree bit for bit too.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from rdst_tpu_torch import _build
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch.ops import radix_sort
from rdst_tpu_torch.utils.trace import span, traced

__all__ = [
    "fused_sort", "fused_sort_available", "pick_blocks", "tail_call",
    "span_call", "tail_plain", "span_plain", "tail_cuda", "span_cuda",
    "TAIL", "SPAN", "MAX_PLANES", "GRAIN", "ELEMS", "elems_per_thread",
    "piece_merge", "piece_merge_plain", "piece_merge_cuda", "PIECE_MERGE",
    "MERGE_THREADS", "MERGE_ELEMS", "merge_tile",
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
#: The route the latest :func:`fused_sort` call took: ``"B8"`` (the radix
#: passes) or ``"B2/B3"`` (the network).  The shuffle reads it to name the
#: route of each per-shard sort.
last_route: str | None = None
_MAX_LEVELS = 32  # levels of one tail launch: its plan stays within _MAX_STEPS
_SMEM_MAX = 227 * 1024  # bytes of shared memory one CTA may use on sm_90
#: Elements per thread and plane of the B2/B3 kernels, by plane count
#: (kElems in csrc/bitonic.cu): at most 64 registers of data a thread.
ELEMS = {1: 32, 2: 32, 3: 16, 4: 16, 5: 8, 6: 8, 7: 8, 8: 4}
_SMALL_ELEMS = 2  # kSmallElems: blocks below 32 * ELEMS[k] elements
_NET_THREADS = 512  # kNetThreads: most threads of a B2/B3 CTA
_MAX_STEPS = 768  # kMaxSteps
_FLIP, _REG, _LANE, _MOVE = 0, 1, 2, 3  # plan steps (csrc/bitonic.cu)
_NO_DIR = 127  # kNoDir: a FLIP's unused second direction

_PLANE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_int, ctypes.c_longlong]
_PLAN_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
TAIL = _build.Kernel(
    "bitonic_tail", "rdst_bitonic_tail", _PLANE_ARGS + [ctypes.c_int] + _PLAN_ARGS,
)
SPAN = _build.Kernel(
    "bitonic_span",
    "rdst_bitonic_span",
    _PLANE_ARGS + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int] + _PLAN_ARGS,
)
PIECE_MERGE = _build.Kernel(
    "piece_merge",
    "rdst_piece_merge",
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p],
)
#: Threads of a B7 block and elements each merges, by key planes
#: (kMergeThreads, merge_elems in csrc/piece_merge.cu).
MERGE_THREADS = 256
MERGE_ELEMS = {1: 15, 2: 15, 3: 11, 4: 11, 5: 7, 6: 7, 7: 7, 8: 7}


def _log2(x: int) -> int:
    return int(x).bit_length() - 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def elems_per_thread(n_planes: int, block: int) -> int:
    """Elements of each plane one B2/B3 thread holds for ``block``: ELEMS,
    or 2 for blocks too small to give a warp of threads at ELEMS."""
    e = ELEMS[n_planes]
    return e if block >= 32 * e else _SMALL_ELEMS


def pick_blocks(n_planes: int) -> tuple[int, int]:
    """(small, big) blocks (elements) of the B2/B3 kernels for ``n_planes``.

    The largest power of two that one CTA holds: at most 512 threads of
    ELEMS[n_planes] elements each, and a staging tile of every plane (u32 at
    most) plus a one-plane u32 transpose buffer within
    ``config.bitonic_smem_bytes``.  On the TPU the multi-level trip-1 kernel
    needed a smaller block than the single-level sweeps (scoped-VMEM stack);
    a CTA has no such extra cost, so both are the same here."""
    k = max(n_planes, 1)
    cap = min(config.bitonic_smem_bytes // (4 * (k + 1)),
              _NET_THREADS * ELEMS[min(k, MAX_PLANES)])
    big = 1 << _log2(max(cap, 2 * GRAIN))
    return big, big


# ---------------------------------------------------------------------------
# Kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _ones_mask(dtypes, n_keys):
    return [P.all_ones(dt) if j < n_keys else 0 for j, dt in enumerate(dtypes)]


def _asc_stages(v, n_keys, strides):
    """Ascending compare-exchange stages over int64 planes ``v`` at
    ``strides``: pairs (lo, lo + s) swap when the first ``n_keys`` planes
    are lexicographically greater at lo; every plane follows."""
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
    return v


def _stages_plain(v, ones, strides, desc):
    """:func:`_asc_stages`, except that where ``desc`` is set the key planes
    (``ones[j]`` != 0) are complemented around them, which makes those runs
    descending."""
    n_keys = sum(1 for o in ones if o)
    v = [torch.where(desc, x ^ o, x) if o else x for x, o in zip(v, ones)]
    v = _asc_stages(v, n_keys, strides)
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


def _plane_ptrs(planes, outs=None):
    """Pointer and width arrays for a C entry point; ``outs`` default to new
    tensors (pass ``planes`` itself to run in place)."""
    if outs is None:
        outs = [torch.empty_like(p) for p in planes]
    k = len(planes)
    ins_a = (ctypes.c_void_p * k)(*[p.data_ptr() for p in planes])
    outs_a = (ctypes.c_void_p * k)(*[p.data_ptr() for p in outs])
    widths = (ctypes.c_int * k)(*[p.dtype.itemsize for p in planes])
    return outs, ins_a, outs_a, widths


def _check_fit(planes, block):
    """Raise unless ``block`` fits one B2/B3 CTA (csrc/bitonic.cu
    ``launch``): at most _NET_THREADS threads, the staging tile and the
    transpose buffer within a CTA's shared memory."""
    k = len(planes)
    threads = block // elems_per_thread(k, block)
    smem = 4 * block + sum(-(-block * p.dtype.itemsize // 16) * 16 for p in planes)
    if threads > _NET_THREADS or smem > _SMEM_MAX:
        raise ValueError(
            f"block {block} x {k} planes exceeds a B2/B3 CTA "
            f"({threads} threads, {smem} B of shared memory)"
        )


def _net_plan(levels, block, n_planes, flip=None):
    """The steps a B2/B3 kernel runs on a tile of ``block`` elements.

    ``levels``: (direction, stage bits) pairs in order; ``flip``: the
    un-flip's bit, or None.  A direction (or the un-flip's bit) is an
    element bit of the tile (>= 0), or -1-b for bit b of the tile's run
    index (B2: the tile, B3: the cell's a), the same for the whole tile.
    Every stage runs ascending: a FLIP before and after each level
    complements the keys of its descending runs, as the Pallas kernels do
    (one FLIP with two directions where one level ends and the next begins).
    A level whose direction is None has no descending runs and no FLIP (B5:
    the merge phase, ascending everywhere).

    Layout a puts the R = log2(E) register bits of a thread at element bits
    [a, a + R); the thread index fills the other bits from the bottom, its
    low five (lane) bits first.  A stage on a register bit compares
    registers.  Any other stage first moves the tile to a layout that holds
    it, the one whose register bits end at it (layout 0 below R); layouts 1-4
    put lanes on bits that share banks, so the stages above the register
    bits and below 5 shuffle across lanes instead, or move to such a layout
    when they are not lane bits.  Returns (first layout, ops, bits, dirs)."""
    e = elems_per_thread(n_planes, block)
    L, R = _log2(block), _log2(e)
    lanes = min(5, L - R)

    def kind(j, a):
        if a <= j < a + R:
            return _REG
        if R <= j < 5 and (j if j < a else j - R) < lanes:
            return _LANE
        return None

    def pick(j):
        if j < R:
            return 0
        if j >= 5:
            return min(max(5, j - R + 1), L - R)
        return j - R + 1

    first = [b for _, bits in levels for b in bits]
    a = a0 = pick(first[0]) if first else 0
    steps = [] if flip is None else [(_FLIP, _NO_DIR, flip)]

    def flip_by(d):  # two FLIPs in a row are one
        if d is None:
            return
        if steps and steps[-1][0] == _FLIP and steps[-1][1] == _NO_DIR:
            steps[-1] = (_FLIP, d, steps[-1][2])
        else:
            steps.append((_FLIP, _NO_DIR, d))

    for d, bits in levels:
        flip_by(d)
        for j in bits:
            k = kind(j, a)
            if k is None:
                a = pick(j)
                steps.append((_MOVE, a, 0))
                k = kind(j, a)
            steps.append((k, j, 0))
        flip_by(d)
    if len(steps) > _MAX_STEPS:
        raise ValueError(f"{len(steps)} steps exceed one B2/B3 launch")
    ops, bits, dirs = (list(x) for x in zip(*steps)) if steps else ([], [], [])
    return a0, ops, bits, dirs


def _plan_args(block, n_planes, levels, flip=None):
    """Elements per thread and the plan as C arrays for a kernel launch."""
    a0, ops, bits, dirs = _net_plan(levels, block, n_planes, flip)
    n = len(ops)
    arr = ctypes.c_int8 * max(n, 1)
    return [elems_per_thread(n_planes, block), arr(*ops), arr(*bits),
            arr(*dirs), n, a0]


def _dir_code(bit, log_block):
    """A global index bit as a plan direction for tiles of 2^log_block."""
    return bit if bit < log_block else -1 - (bit - log_block)


def _tail_net(levels, unflip_shift, block):
    """A tail launch's levels and un-flip as :func:`_net_plan` takes them:
    (direction code or None, stage bits) per level, and the un-flip's
    code."""
    L = _log2(block)
    net = [(None if log_2r is None else _dir_code(log_2r, L),
            [_log2(s) for s in _strides(start)]) for log_2r, start in levels]
    return net, None if unflip_shift is None else _dir_code(unflip_shift, L)


def _tail_launch(kernel, planes, n, block, n_keys, levels, unflip_shift,
                 in_place):
    """Launch ``rdst_bitonic_tail`` (counted on ``kernel``: B2's TAIL or
    B5's MERGE_TAIL).  In place, each tile is read and written by one CTA,
    so outputs may be the inputs."""
    planes = [p.contiguous() for p in planes]
    _check_tail(planes, n, block, n_keys, levels)
    dev, _ = _build.check_cuda_planes(planes, P.UNSIGNED)
    _check_fit(planes, block)
    net, flip = _tail_net(levels, unflip_shift, block)
    outs, ins_a, outs_a, widths = _plane_ptrs(planes, planes if in_place else None)
    kernel.launch(
        dev, ins_a, outs_a, widths, len(planes), n_keys, n, block,
        *_plan_args(block, len(planes), net, flip),
        _build.stream_of(planes[0]),
    )
    return outs


def tail_cuda(planes, n, block, n_keys, levels, unflip_shift):
    """Launch the tail kernel of ``csrc/bitonic.cu``."""
    return _tail_launch(TAIL, planes, n, block, n_keys, levels, unflip_shift,
                        False)


def span_cuda(planes, n, s_hi, s_lo, two_r, block, n_keys):
    """Launch the span kernel of ``csrc/bitonic.cu``: the cell's stages are
    its piece bits, log2(block) - 1 down to log2(block / P)."""
    planes = [p.contiguous() for p in planes]
    p_dim = _span_geometry(n, s_hi, s_lo, two_r, block)
    _check_planes(planes, n, n_keys)
    dev, _ = _build.check_cuda_planes(planes, P.UNSIGNED)
    _check_fit(planes, block)
    L = _log2(block)
    net = [(-1 - _log2(two_r // (2 * s_hi)),
            list(range(L - 1, L - 1 - _log2(p_dim), -1)))]
    outs, ins_a, outs_a, widths = _plane_ptrs(planes)
    SPAN.launch(
        dev, ins_a, outs_a, widths, len(planes), n_keys, n, s_hi, s_lo, block,
        *_plan_args(block, len(planes), net), _build.stream_of(planes[0]),
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


def merge_tile(n_keys: int) -> int:
    """Output elements of one B7 block at ``n_keys`` key planes."""
    return MERGE_THREADS * MERGE_ELEMS[n_keys]


def _check_merge(a, b, n_keys):
    if len(a) != len(b):
        raise ValueError("both runs need the same planes")
    _check_planes(a, int(a[0].shape[0]), n_keys)
    _check_planes(b, int(b[0].shape[0]), n_keys)
    if any(x.dtype != y.dtype for x, y in zip(a, b)):
        raise ValueError("both runs need the same plane dtypes")


def piece_merge_plain(a, b, n_keys):
    """Plain PyTorch version of B7: the stable sort of the concatenation
    ``a ++ b`` by the first ``n_keys`` planes, which is the stable merge of
    two ascending runs (on equal keys ``a`` first)."""
    _check_merge(a, b, n_keys)
    PIECE_MERGE.plain_calls += 1
    return P.lex_sort([P.cat([x, y]) for x, y in zip(a, b)], n_keys, stable=True)


def piece_merge_cuda(a, b, n_keys):
    """Launch B7 (``csrc/piece_merge.cu``): the partition of the output into
    tiles, then one block a tile."""
    a = [p.contiguous() for p in a]
    b = [p.contiguous() for p in b]
    _check_merge(a, b, n_keys)
    dev, la = _build.check_cuda_planes(a, P.UNSIGNED)
    dev_b, lb = _build.check_cuda_planes(b, P.UNSIGNED)
    if dev_b != dev:
        raise ValueError("both runs must lie on one CUDA device")
    k = len(a)
    outs = [torch.empty(la + lb, dtype=p.dtype, device=dev) for p in a]
    splits = torch.empty(-(-(la + lb) // merge_tile(n_keys)) + 1,
                         dtype=torch.int64, device=dev)
    ptrs = [(ctypes.c_void_p * k)(*[p.data_ptr() for p in ps]) for ps in (a, b, outs)]
    widths = (ctypes.c_int * k)(*[p.dtype.itemsize for p in a])
    PIECE_MERGE.launch(dev, *ptrs, widths, k, n_keys, la, lb, splits.data_ptr(),
                       splits.numel(), _build.stream_of(a[0]))
    return outs


def piece_merge(a, b, n_keys):
    """B7: merge ascending runs ``a`` and ``b`` (lists of the same planes,
    keys first) into new planes of both lengths, ascending and stable (on
    equal keys ``a`` first); the kernel for CUDA planes, the plain version
    for CPU planes."""
    fn = piece_merge_cuda if _on_cuda(a) else piece_merge_plain
    return fn(list(a), list(b), n_keys)


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


@traced("fused_sort")
def fused_sort(
    words: Sequence[torch.Tensor],
    payloads: Sequence[torch.Tensor] = (),
    *,
    stable: bool = False,
    row: int | None = None,
    block: int | None = None,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Sort key word planes (most significant first) + payload planes.

    Rows that ``radix_sort.takes`` sort by the radix passes, in the order
    of a stable sort whatever ``stable`` says; the others by the network.
    ``row`` and ``block`` override the network's phase-0 row length and
    small block (tests use them to run every kernel shape at small n).
    :data:`last_route` names the route taken.  The call is the
    ``rdst.fused_sort`` span; the radix passes are its ``radix`` child, and
    each piece's phase 0 and B2/B3 trips, and the pieces' merge, are its
    ``phase0``, ``network`` and ``merge`` children."""
    global last_route
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

    if radix_sort.takes(kplanes, pplanes):
        last_route = "B8"
        with span("fused_sort.radix"):
            out_k, out_p = radix_sort.radix_sort(kplanes, pplanes)
        return ([r(p) for p, (_, r) in zip(out_k, wk)],
                [r(p) for p, (_, r) in zip(out_p, wp)])
    last_route = "B2/B3"

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
    acc = _sort_piece([p[: pieces[0][1]] for p in planes], n_keys, blk_s, blk_b, m)
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
        pc = _sort_piece(sub, nk_piece, blk_s, blk_b, m)
        if nk_piece != n_keys:
            acc = acc[:n_keys] + [P.full(la, 0, torch.uint8, dev)] + acc[n_keys:]
            n_keys = nk_piece
        la += ln
        with span("fused_sort.merge"):
            acc = piece_merge(acc, pc, n_keys)
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
    with span("fused_sort.phase0"):
        gid = torch.arange(T, device=dev)
        flip = ((gid >> log_m) & 1) == 1
        planes = [
            P.where(flip, P.complement(p), p) if j < n_keys else p
            for j, p in enumerate(planes)
        ]
        rows = P.lex_sort([p.reshape(T // m, m) for p in planes], n_keys, dim=1)
        planes = [p.reshape(T) for p in rows]

    with span("fused_sort.network"):
        # trip 1: un-flip + every level up to run length blk_s
        levels = [(l2r, 1 << (l2r - 1)) for l2r in range(log_m + 1, log_bs + 1)]
        planes = tail_call(planes, T, blk_s, n_keys, levels, unflip_shift=log_m)

        # larger levels: span trips for strides R..blk_b, then one tail
        # sweep.  The span fan-in keeps pieces at least GRAIN elements long.
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


def _sort_piece(planes, n_keys, blk_s, blk_b, m):
    """Sort one power-of-two piece ascending."""
    ln = int(planes[0].shape[0])
    if ln >= config.fused_min_piece and min(blk_s, ln) >= 2 * GRAIN and m >= 2:
        return _core(list(planes), ln, n_keys, blk_s, blk_b, m)
    return P.lex_sort(planes, n_keys, stable=False)
