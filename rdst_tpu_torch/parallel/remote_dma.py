"""The exchange of the distributed shuffle (kernel B6).

Port of ``rdst_tpu/parallel/remote_dma.py``.  Every sender copies its
segment for destination d into d's receive buffer; the result is the
contract of the ragged branch of ``shuffle._exchange_raw``: received
planes, and each receiver's exact demand (the rows it was sent, which may
exceed its buffer: the overflow signal).

The TPU kernel sends 128-lane-aligned segments in fixed chunks of 16 x 128
elements into chunk-rounded receiver slots (``dma_layout``), because that is
the addressing its DMA engine does well.  A CUDA copy addresses elements, so
the port keeps only the exact ragged layout of ``ragged_all_to_all``: sender
s's segment for d lands at offset ``sum(size[:s, d])`` of d's buffer
(:func:`exchange_layout`).  Kernel and plain version therefore agree bit for
bit, pads included.

:func:`remote_dma_exchange` is the wrapper: CUDA planes launch
``csrc/exchange.cu`` once per call, whatever the number of shards and
planes, on PyTorch's current stream, with no host synchronisation; CPU
planes run :func:`remote_dma_exchange_plain`, slice copies in PyTorch.
An exchange has S senders and R receivers: the size matrix is (S, R), and
receive buffers are one allocation of R x capacity elements per plane, left
empty: the kernel writes every word once, a received row or the pad word.
Receiver d's buffer is the view ``[d * capacity, (d + 1) * capacity)``.
Within one process S == R (every shard sends to every shard).  On a mesh
that spans processes (``parallel/shuffle.py``) the receivers are this
process's shards and the senders every shard of the group: a remote
sender's plane is its block of the buffer that ``torch.distributed``
delivered, its offsets the running sums of its segments.  All planes of a
call lie on one device: stream order stands in for the reference's barrier
(the collective that filled a remote block is ordered before the launch on
the current stream).  Shards on several cards of one process (peer-mapped
destination pointers, events in place of the barrier) are later work.

Planes are u32.  Any other dtype raises ``TypeError`` before anything is
allocated or launched: the reference's docstring promised a fallback for
narrow planes that its code never had (remote_dma.py:41-43 against
:217-221).  The shuffle itself views 4-byte payloads as u32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from rdst_tpu_torch import _build
from rdst_tpu_torch import _planes as P

__all__ = [
    "PAD_WORD", "EXCHANGE", "Layout", "exchange_layout", "remote_dma_exchange",
    "remote_dma_exchange_plain", "remote_dma_exchange_cuda", "launch_all",
]

PAD_WORD = 0xFFFFFFFF

EXCHANGE = _build.Kernel(
    "remote_exchange", "rdst_remote_exchange",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
)


class Layout(NamedTuple):
    """Where every segment of an exchange lands, from the (S, R) size matrix
    ``sizes[s, d]`` (rows sender s sends receiver d)."""

    #: (S, R) [s, d]: offset of sender s's segment in receiver d's buffer
    recv_offsets: torch.Tensor
    #: (S, R) [s, d]: elements of that segment that land inside the buffer
    landed: torch.Tensor
    #: (R,) rows each receiver is sent (its reported count)
    demand: torch.Tensor


def exchange_layout(size_matrix: torch.Tensor, capacity: int) -> Layout:
    """The port's counterpart of ``dma_layout``: exact ragged offsets.

    Sender and receiver read the same matrix, so where sender s writes on
    receiver d is where d expects s; a segment that would cross the
    capacity keeps only its part below it, so no write leaves the buffer."""
    sm = size_matrix.to(torch.int64)
    recv_off = torch.cumsum(sm, 0) - sm
    landed = torch.clamp(torch.minimum(sm, capacity - recv_off), min=0)
    return Layout(recv_off, landed, sm.sum(0))


def _check(planes, input_offsets, send_sizes):
    """(S senders, R receivers, planes per sender)."""
    S = len(planes)
    if S < 1 or len(input_offsets) != S or len(send_sizes) != S:
        raise ValueError("one plane list, offset and size vector per sender")
    R = int(send_sizes[0].shape[0]) if send_sizes[0].ndim == 1 else -1
    k = len(planes[0])
    for ps in planes:
        if len(ps) != k:
            raise ValueError("every sender sends the same number of planes")
        for p in ps:
            if p.dtype != torch.uint32:
                raise TypeError(
                    f"remote_dma_exchange carries u32 planes only, got {p.dtype}"
                )
            if p.ndim != 1:
                raise ValueError("exchange planes must be 1-D")
    for v in list(input_offsets) + list(send_sizes):
        if R < 1 or v.shape != (R,):
            raise ValueError("offsets and sizes must be one (R,) vector per "
                             "sender, R >= 1 receivers")
    return S, R, k


def remote_dma_exchange_plain(planes, input_offsets, send_sizes, capacity):
    """Plain PyTorch version of B6: the same layout, by slice copies.

    Returns ``(recv, demand, arrived)``: ``recv[j]`` is plane j of every
    receiver, (R * capacity,) with the pad word where nothing landed;
    ``demand`` (R,) int64; ``arrived`` (planes, R) int64, the elements that
    landed per receiver, min(demand, capacity)."""
    S, R, k = _check(planes, input_offsets, send_sizes)
    dev = planes[0][0].device
    offs = torch.stack([o.to(dev, torch.int64) for o in input_offsets])
    sizes = torch.stack([s.to(dev, torch.int64) for s in send_sizes])
    lay = exchange_layout(sizes, capacity)
    offs, dst, landed = offs.tolist(), lay.recv_offsets.tolist(), lay.landed.tolist()
    recv = [P.full(R * capacity, PAD_WORD, torch.uint32, dev) for _ in range(k)]
    for j in range(k):
        for s in range(S):
            EXCHANGE.plain_calls += 1
            src = planes[s][j]
            for d in range(R):
                m = landed[s][d]
                if m:
                    o = d * capacity + dst[s][d]
                    recv[j][o: o + m] = src[offs[s][d]: offs[s][d] + m]
    arrived = lay.landed.sum(0).expand(k, R).clone()
    return recv, lay.demand, arrived


def remote_dma_exchange_cuda(planes, input_offsets, send_sizes, capacity):
    """Launch B6 (``csrc/exchange.cu``) once for the whole exchange.  Same
    return as :func:`remote_dma_exchange_plain`; ``arrived`` is counted by
    the kernel."""
    S, R, k = _check(planes, input_offsets, send_sizes)
    flat = [p for ps in planes for p in ps]
    dev, _ = _build.check_cuda_planes(flat[:1], (torch.uint32,))
    for p in flat:
        if p.device != dev or not p.is_contiguous():
            raise ValueError("exchange planes must be contiguous, on one CUDA device")
    offs = torch.stack([o.to(dev, torch.int64) for o in input_offsets])
    sizes = torch.stack([s.to(dev, torch.int64) for s in send_sizes])
    recv = [torch.empty(R * capacity, dtype=torch.uint32, device=dev) for _ in range(k)]
    arrived = torch.zeros((k, R), dtype=torch.int64, device=dev)
    launch_all(planes, offs, sizes, recv, arrived, capacity)
    return recv, sizes.sum(0), arrived


def _pointer_table(planes, recv, capacity) -> list[int]:
    """The kernel's table of addresses: sender s's plane j at ``j * S + s``,
    then receiver d's buffer of plane j (``recv[j]`` from element
    ``d * capacity``; R = ``len(recv[j]) // capacity`` receivers) at
    ``k * S + j * R + d``, ``(k + j) * D + d`` when S == R == D."""
    S, R = len(planes), int(recv[0].shape[0]) // capacity
    src = [planes[s][j].data_ptr() for j in range(len(recv)) for s in range(S)]
    dst = [r.data_ptr() + 4 * capacity * d for r in recv for d in range(R)]
    return src + dst


def launch_all(planes, offs, sizes, recv, arrived, capacity):
    """The one launch of an exchange, on buffers the caller prepared:
    ``offs`` and ``sizes`` (S, R) int64 on the planes' device; ``recv`` one
    (R * capacity,) u32 plane per sent plane, whatever it holds (every word
    is written, at :func:`exchange_layout`'s offsets, which the kernel sums
    itself); adds the landed elements to ``arrived`` (planes, R).  Split
    out so the launch can be timed without the allocations."""
    S = len(planes)
    R = int(sizes.shape[-1])
    if not recv or capacity == 0:
        return  # no receive word to write
    dev = recv[0].device
    tabs = [t.contiguous() for t in (offs, sizes)]
    for t in tabs:
        if t.dtype != torch.int64 or t.shape != (S, R) or t.device != dev:
            raise ValueError(f"offsets and sizes must be ({S}, {R}) int64 on {dev}")
    for r in recv:
        if (r.dtype != torch.uint32 or r.shape != (R * capacity,)
                or not r.is_contiguous() or r.device != dev):
            raise ValueError(f"receive planes must be ({R * capacity},) u32 on {dev}")
    if arrived.dtype != torch.int64 or arrived.shape != (len(recv), R) \
            or not arrived.is_contiguous() or arrived.device != dev:
        raise ValueError(f"arrived must be ({len(recv)}, {R}) int64 on {dev}")
    # pinned, so the copy is asynchronous: the host waits for nothing
    table = torch.tensor(_pointer_table(planes, recv, capacity),
                         dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    EXCHANGE.launch(
        dev, table.data_ptr(), *[t.data_ptr() for t in tabs], S, R, len(recv),
        capacity, arrived.data_ptr(), _build.stream_of(recv[0]),
    )


def remote_dma_exchange(
    planes: Sequence[Sequence[torch.Tensor]],
    input_offsets: Sequence[torch.Tensor],
    send_sizes: Sequence[torch.Tensor],
    capacity: int,
):
    """Exchange contiguous per-destination segments from S senders to R
    receivers (S == R == D among the D shards of one process).

    ``planes[s]``: sender s's u32 planes; ``input_offsets[s]`` and
    ``send_sizes[s]``: (R,) where s's segment for each receiver starts and
    how long it is.  Returns ``(recv, demand, arrived)`` as
    :func:`remote_dma_exchange_plain` describes.  CUDA planes launch the
    kernel (or raise); CPU planes run the plain version."""
    dev = planes[0][0].device.type
    if dev == "cuda":
        return remote_dma_exchange_cuda(planes, input_offsets, send_sizes, capacity)
    if dev != "cpu":
        raise ValueError(f"no exchange kernel for device {planes[0][0].device}")
    return remote_dma_exchange_plain(planes, input_offsets, send_sizes, capacity)
