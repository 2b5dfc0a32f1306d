"""Fused bitonic merge (kernels B4 and B5).

Port of ``rdst_tpu/ops/pallas_merge.py``.  A bitonic sequence (an ascending
run followed by a descending one) sorts with the merge phase of a bitonic
network: stages at strides n/2, n/4, ..., 1, all ascending.  The plain
stage loop (``ops/merge.py``) makes one pass through device memory per
stage and several kernels per pass; here:

  B4 (stride >= block)  one pass per stride, ``csrc/merge.cu``
                        ``merge_stage_kernel``: pairs (lo, lo + s) compared
                        and exchanged in registers;
  B5 (stride < block)   one pass for every remaining stride: B2's kernel
                        (``csrc/bitonic.cu`` ``rdst_bitonic_tail``) on a
                        plan of one level with no direction, strides
                        block/2 .. 1, ascending on every aligned block.  A
                        tile lives in registers (``fused_sort`` says how);
                        launches count on ``MERGE_TAIL``, apart from B2's.

The block is :func:`pick_block`, B2's big block (``fused_sort.pick_blocks``).
Both kernels compare strictly (ties never swap), so their output depends
only on the stage sequence, which is the stage loop's: kernels, plain
versions, the Pallas kernels and the XLA loop agree bit for bit, riders
included.

:func:`merge_stage_call` and :func:`merge_tail_call` are the wrappers: CUDA
planes launch the kernel (or raise), CPU planes run
:func:`merge_stage_plain` / :func:`merge_tail_plain`.  With ``in_place=True``
the kernels write into the planes they are given; callers pass it only for
planes they own.  The plain versions always return new tensors.

``rev_fast`` (a faster reversal on the TPU) is a plain flip here;
``mosaic_params`` and ``sds_like`` have no counterpart.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from rdst_tpu_torch import _build
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.ops import fused_sort as fs

__all__ = [
    "bitonic_merge_fused", "fused_merge_available", "merge_level",
    "pick_block", "merge_stage_call", "merge_tail_call", "merge_stage_plain",
    "merge_tail_plain", "merge_stage_cuda", "merge_tail_cuda", "MERGE_STAGE",
    "MERGE_TAIL",
]

_PLANE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_int, ctypes.c_longlong]
MERGE_STAGE = _build.Kernel(
    "merge_stage", "rdst_merge_stage",
    _PLANE_ARGS + [ctypes.c_longlong, ctypes.c_void_p],
)
MERGE_TAIL = _build.Kernel("merge_tail", "rdst_bitonic_tail", fs.TAIL.argtypes)


def pick_block(n_planes: int) -> int:
    """B5's block (elements) for ``n_planes`` planes: B2's big block, the
    largest one CTA of ``csrc/bitonic.cu`` holds (2^14 at 1-2 planes, 2^13
    at 3-4, 2^12 at 5-7, 2^11 at 8).  Replaces the v5e VMEM rule of
    ``pallas_merge.pick_block``."""
    return fs.pick_blocks(n_planes)[1]


def _check_stage(planes, n, s, n_keys):
    fs._check_planes(planes, n, n_keys)
    if n < 2 or n & (n - 1) or s < 1 or s & (s - 1) or 2 * s > n:
        raise ValueError(f"stride {s} needs a power-of-two length >= 2s, got {n}")


def _check_tail(planes, n, block, n_keys):
    fs._check_planes(planes, n, n_keys)
    if block < 2 or block & (block - 1) or n % block:
        raise ValueError(f"tail block {block} must be a power of two dividing {n}")


def _plain(planes, n_keys, strides):
    dtypes = [p.dtype for p in planes]
    v = fs._asc_stages([P.widen(p) for p in planes], n_keys, strides)
    return [P.narrow(x, dt) for x, dt in zip(v, dtypes)]


def merge_stage_plain(planes, n, s, n_keys):
    """Plain PyTorch version of B4: one ascending stage at stride ``s``."""
    _check_stage(planes, n, s, n_keys)
    MERGE_STAGE.plain_calls += 1
    return _plain(planes, n_keys, [s])


def merge_tail_plain(planes, n, block, n_keys):
    """Plain PyTorch version of B5: ascending stages at strides
    ``block/2 .. 1`` (each stays inside its aligned block)."""
    _check_tail(planes, n, block, n_keys)
    MERGE_TAIL.plain_calls += 1
    return _plain(planes, n_keys, fs._strides(block // 2))


def merge_stage_cuda(planes, n, s, n_keys, *, in_place=False):
    """Launch B4 (``csrc/merge.cu``)."""
    _check_stage(planes, n, s, n_keys)
    planes = [p.contiguous() for p in planes]
    dev, _ = _build.check_cuda_planes(planes, P.UNSIGNED)
    outs, ins_a, outs_a, widths = fs._plane_ptrs(planes, planes if in_place else None)
    MERGE_STAGE.launch(dev, ins_a, outs_a, widths, len(planes), n_keys, n, s,
                       _build.stream_of(outs[0]))
    return outs


def merge_tail_cuda(planes, n, block, n_keys, *, in_place=False):
    """Launch B5: ``rdst_bitonic_tail`` (``csrc/bitonic.cu``) on one
    direction-less level at strides block/2 .. 1."""
    return fs._tail_launch(MERGE_TAIL, list(planes), n, block, n_keys,
                           [(None, block // 2)], None, in_place)


def merge_stage_call(planes, n, s, n_keys, *, in_place=False):
    """B4: one ascending stage at stride ``s``; the kernel for CUDA planes,
    the plain version for CPU planes."""
    if fs._on_cuda(planes):
        return merge_stage_cuda(list(planes), n, s, n_keys, in_place=in_place)
    return merge_stage_plain(list(planes), n, s, n_keys)


def merge_tail_call(planes, n, block, n_keys, *, in_place=False):
    """B5: every stride ``block/2 .. 1`` in one pass; the kernel for CUDA
    planes, the plain version for CPU planes."""
    if fs._on_cuda(planes):
        return merge_tail_cuda(list(planes), n, block, n_keys, in_place=in_place)
    return merge_tail_plain(list(planes), n, block, n_keys)


def fused_merge_available(
    planes: Sequence[torch.Tensor], n_keys: int | None = None
) -> bool:
    """True when the fused merge can take these planes: a power-of-two
    length of at least 2 * GRAIN, at most MAX_PLANES planes, key planes
    (the first ``n_keys``, default all) unsigned integers of at most 32
    bits, riders of at most 32 bits and neither bool nor an 8-bit float.
    The device is not part of the gate: the kernel wrappers decide by it."""
    n = int(planes[0].shape[0])
    if n < 2 * fs.GRAIN or n & (n - 1) or len(planes) > fs.MAX_PLANES:
        return False
    nk = len(planes) if n_keys is None else n_keys
    for i, p in enumerate(planes):
        dt = p.dtype
        if dt == torch.bool or dt.is_complex or dt.itemsize > 4:
            return False
        if i < nk and dt not in P.UNSIGNED:
            return False
        if dt.is_floating_point and dt.itemsize < 2:
            return False
    return True


def _run_stages(z, n, m, n_keys, in_place):
    """Strides m .. 1 (ascending) on the planes ``z`` of length n: B4 for
    the strides at or above the block, B5 for the rest.  After the first
    launch every plane is the function's own, so later ones run in place."""
    blk = pick_block(len(z))
    s = m
    while s >= max(blk, 2 * fs.GRAIN) and 2 * m > blk:
        z = merge_stage_call(z, n, s, n_keys, in_place=in_place)
        in_place = True
        s //= 2
    return merge_tail_call(z, n, min(blk, 2 * m), n_keys, in_place=in_place)


def bitonic_merge_fused(
    z: Sequence[torch.Tensor], n_keys: int, *, in_place: bool = False
) -> list[torch.Tensor]:
    """Sort a bitonic plane list (an ascending run followed by a descending
    one, as ``ops/merge.py`` builds it: ``cat(a, flip(b))``) with fused
    stages.  Planes have one power-of-two length; the first ``n_keys`` are
    the key, most significant first.  ``in_place=True`` lets the kernels
    write into ``z``."""
    n = int(z[0].shape[0])
    wz = [fs._norm_plane(p) for p in z]
    out = _run_stages([p for p, _ in wz], n, n // 2, n_keys, in_place)
    return [r(p) for p, (_, r) in zip(out, wz)]


def merge_level(
    planes: Sequence[torch.Tensor], m: int, n_keys: int
) -> list[torch.Tensor]:
    """Merge every adjacent pair of sorted length-``m`` runs, batched.

    ``planes`` are flat, their length a multiple of 2m (m a power of two),
    and run i occupies ``[i*m, (i+1)*m)``.  A stage of stride s <= m only
    mixes elements inside aligned 2s-blocks, which never cross a pair
    boundary, so each launch advances every pair at once."""
    n = int(planes[0].shape[0])
    if m < 1 or m & (m - 1) or n % (2 * m):
        raise ValueError(f"run length {m} must be a power of two and 2m divide {n}")
    wz = [fs._norm_plane(p) for p in planes]
    z = []
    for p, _ in wz:
        v = P.sview(p).view(-1, 2, m)
        z.append(torch.stack([v[:, 0], v[:, 1].flip(1)], 1).reshape(n)
                 .view(p.dtype))
    out = _run_stages(z, n, m, n_keys, in_place=True)
    return [r(p) for p, (_, r) in zip(out, wz)]
