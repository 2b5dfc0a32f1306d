"""A mesh of shards: the counterpart of ``jax.sharding.Mesh``.

The JAX package runs the shuffle inside ``shard_map``: one program per
device, with collectives (``psum``, ``pmin``, ``pmax``, ``all_gather``,
``axis_index``) between them.  Here the shards of a mesh run in lockstep in
each process that holds them: a per-shard value is a list over this
process's shards (:attr:`Mesh.shards`), and the collectives are functions
of such lists that return one replicated tensor.  Any number of shards may
share one device, so a mesh of 8 shards on one H100 runs the shuffle's real
all-to-all traffic (HBM to HBM) and the CPU tests run the same code as the
JAX package's virtual 8-device mesh.

After :func:`init_distributed` with more than one process, a mesh spans
the processes of the default process group: process p holds the flat
shards ``[p * L, (p + 1) * L)``, L = size / world size, so on
``make_mesh_2d(world, C)`` each process holds one host row, as
``jax.devices()``' process-major order gives the reference.  The
collectives then reduce this process's shards first and call
``torch.distributed`` once (``all_reduce`` or ``all_gather``).  Under NCCL
the tensors stay on the card and the host waits for none of them.  Under
gloo, which has no collectives for CUDA tensors of every kind, each
collective copies its tensor to the CPU and back: a blocking round trip
through the host, the cost of the backend the caller chose, made explicit
here.  Collectives carry int64 (gloo refuses uint32): any other dtype
raises before a call.  Without a process group, or with one process, a
mesh holds every shard and calls nothing.  A rank may hold several cards
too (below): the reference's multi-host pod, one process per host driving
all of its chips.

The collectives reduce over every shard of the mesh (the shuffle's body
reduces over its whole partition axis, a tuple of both axes on a 2-axis
mesh); :meth:`Mesh.groups` names the shards that exchange along one axis
of a 2-axis mesh.

**Cards.**  Each process's block of a mesh may lie on several cards:
``devices`` lists K of them (K dividing the L shards of the process), and
card c holds the contiguous flat shards ``[p * L + c * L / K, p * L + (c +
1) * L / K)`` of process p, so in one process on ``make_mesh_2d(H, C,
devices=...)`` with K = H each host row lies on one card, as
``jax.devices()``' process-major order places the reference's, and over H
processes each rank's host row lies on its K cards.
``devices=None`` is ``[device]``: one card, today's mesh, on the caller's
current stream.  With K > 1 each entry is its own card, even where entries
repeat: on CUDA each holds its own ``torch.cuda.Stream``, held by the mesh,
and the cards' work is ordered only by events (:meth:`Mesh.call`,
:meth:`Mesh.on`, the collectives, and the exchange in
``parallel/remote_dma.py``).  So ``devices=["cuda:0"] * 4`` runs the
four-card code on one card, four streams at once, and ``["cpu"] * 4`` the
same grouping through the plain versions: scaffolding for a machine with
one card, the way 8 shards on one card model 8 chips, not a feature of its
own.  Per-shard work runs on its card's stream; replicated values (what the
collectives return, and what is computed from them) live on card 0, the
mesh's ``device``, on card 0's stream, and a card reads one through its own
copy (:meth:`Mesh.replicas`), made once per collective.  No step waits on
the host.  Outputs on K > 1 cards are per card: each output plane (counts
excepted, which stay one replicated (D,) tensor on card 0) is a list over
the cards, entry c card c's (L_c * capacity,) block, shard-major, on card
c; concatenated in card order the blocks are the one-card result, as the
blocks of the processes are on a mesh over processes.

**Ranks that hold several cards.**  Over processes, card 0 of each rank
carries the collectives: under NCCL it must be the current CUDA device (the
card :func:`init_distributed` takes from ``LOCAL_RANK``; the constructor
raises ``ValueError`` otherwise), so the supported layout is torchrun with
one process per host and ``devices`` listing the host's cards.  Under gloo
the collectives run on the CPU (:attr:`Mesh.comm_device`).  Every
collective first gathers the rank's cards onto card 0 (one event per card)
and then makes one ``torch.distributed`` call on card 0's stream.  The
cross-process exchange (``shuffle._exchange_across``) stages each card's
outgoing words to the communicator's device on that card's stream, and
lands what arrives (on card 0) through B6's multi-card form.  Outputs keep
the convention above: concatenated rank by rank, and within a rank card by
card, they are the one-process result.
"""
from __future__ import annotations

import contextlib
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from rdst_tpu_torch.utils.trace import span

__all__ = ["Mesh", "init_distributed", "make_mesh", "make_mesh_2d"]

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


class Mesh:
    """``shape`` shards (row-major over ``axis_names``) on the cards
    ``devices`` (default ``[device]``) of each process, spread over the
    default process group's ranks where it has more than one."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device, devices: Sequence | None = None):
        self.shape = tuple(int(x) for x in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or min(self.shape) < 1:
            raise ValueError(f"bad mesh shape {self.shape} for {self.axis_names}")
        self.devices = [_resolve(d) for d in ([device] if devices is None else devices)]
        if not self.devices:
            raise ValueError("a mesh needs at least one card")
        self.device = self.devices[0]
        self.size = 1
        for x in self.shape:
            self.size *= x
        K = len(self.devices)
        self.processes = (dist.is_available() and dist.is_initialized()
                          and dist.get_world_size() > 1)
        self.rank, self.world = 0, 1
        #: where the collectives run: card 0 under NCCL, else the CPU
        self.comm_device = self.device
        if self.processes:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            if self.size % self.world:
                raise ValueError(f"{self.size} shards do not split evenly over "
                                 f"{self.world} processes")
            if dist.get_backend() != "nccl":
                self.comm_device = torch.device("cpu")
            elif (self.device.type != "cuda"
                  or self.device.index != torch.cuda.current_device()):
                raise ValueError(
                    f"under NCCL a rank's first card carries the communicator and "
                    f"must be the current CUDA device (init_distributed sets it "
                    f"from LOCAL_RANK): got {self.device}")
        self.n_local = self.size // self.world
        if self.n_local % K:
            raise ValueError(f"{self.n_local} shards do not split evenly over {K} cards")
        #: shards a card holds
        self.per_card = self.n_local // K
        #: one stream per card on CUDA with K > 1, else None (the caller's)
        self.streams = ([torch.cuda.Stream(device=d) for d in self.devices]
                        if K > 1 and self.device.type == "cuda" else None)
        self._depth = 0

    @property
    def cards(self) -> range:
        return range(len(self.devices))

    def card_of(self, shard: int) -> int:
        """The card (index into ``devices``) that holds flat shard ``shard``
        of this process."""
        return (shard - self.shards.start) // self.per_card

    def device_of(self, shard: int) -> torch.device:
        return self.devices[self.card_of(shard)]

    def stream_of(self, card: int):
        """Card ``card``'s stream: its own with K > 1 cards, the caller's
        current stream with one; None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self.streams is None:
            return torch.cuda.current_stream(self.device)
        return self.streams[card]

    def on(self, card: int):
        """A context in which work runs on ``card``'s device and stream."""
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[card])

    def each(self):
        """(local shard index, card) over this process's shards, each
        yielded inside :meth:`on` of its card."""
        for c in self.cards:
            with self.on(c):
                for i in range(c * self.per_card, (c + 1) * self.per_card):
                    yield i, c

    @contextlib.contextmanager
    def call(self):
        """One call on the mesh: every card's stream first waits for the
        caller's current stream on its device (the inputs are final), the
        body runs on card 0's stream, and at the end the caller's current
        stream on every card's device waits for that card's stream (the
        outputs are final).  Re-entrant: a call inside a call adds nothing."""
        if self.streams is None or self._depth:
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
            return
        for d, s in zip(self.devices, self.streams):
            s.wait_stream(torch.cuda.current_stream(d))
        self._depth = 1
        try:
            with self.on(0):
                yield
        finally:
            self._depth = 0
            for d, s in zip(self.devices, self.streams):
                torch.cuda.current_stream(d).wait_stream(s)

    def _home(self, xs) -> list:
        """Per-shard values moved to card 0, on card 0's stream, after one
        event per card: a value on card 0's device is used in place (its
        block recorded on card 0's stream), one on another device copied
        there on its card's stream."""
        if self.streams is None:
            return list(xs)
        home = self.streams[0]
        for s in self.streams[1:]:
            home.wait_stream(s)
        out = []
        for i, x in enumerate(xs):
            c = i // self.per_card
            if c == 0:
                out.append(x)
            elif x.device == self.device:
                x.record_stream(home)
                out.append(x)
            else:
                with torch.cuda.stream(self.streams[c]), torch.cuda.stream(home):
                    out.append(x.to(self.device))
        return out

    def replicas(self, *xs) -> list[tuple]:
        """For each card, its own copies of ``xs`` (tensors on card 0, or
        None), made on its stream after one event of card 0's: entry c of
        the list is card c's tuple.  One card, or the CPU: the tensors
        themselves."""
        if self.streams is None:
            return [xs] * len(self.devices)
        home = self.streams[0]
        out = [xs]
        for c in self.cards[1:]:
            s, d = self.streams[c], self.devices[c]
            s.wait_stream(home)
            copies = []
            with torch.cuda.stream(home), torch.cuda.stream(s):
                for x in xs:
                    if x is None:
                        copies.append(None)
                    elif d == self.device:
                        x.record_stream(s)
                        copies.append(x.clone())
                    else:
                        copies.append(x.to(d))
            out.append(tuple(copies))
        return out

    @property
    def shards(self) -> range:
        """Flat indices (row-major, host-major on a 2-axis mesh) of the
        shards this process holds: a contiguous block, all of them in one
        process."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    def owner(self, shard: int) -> int:
        """The rank that holds flat shard ``shard``."""
        return shard // self.n_local

    def spans(self, groups) -> bool:
        """Whether any of ``groups`` has shards in more than one process
        (the same answer on every rank)."""
        return any(self.owner(g[0]) != self.owner(g[-1]) for g in groups)

    def groups(self, axis: str) -> list[list[int]]:
        """The flat shard indices that exchange along ``axis``: one list per
        coordinate of the other axes, in ``axis`` order."""
        i = self.axis_names.index(axis)
        stride = 1
        for x in self.shape[i + 1:]:
            stride *= x
        n = self.shape[i]
        return [
            [base + k * stride for k in range(n)]
            for base in range(self.size)
            if (base // stride) % n == 0
        ]

    def _stack(self, xs) -> torch.Tensor:
        """The shards' values stacked on card 0 (call inside :meth:`on`
        of card 0)."""
        if len(xs) != self.n_local:
            raise ValueError(f"{len(xs)} values for {self.n_local} shards")
        if self.processes:
            for x in xs:
                if x.dtype != torch.int64:
                    raise TypeError(f"collectives carry int64, got {x.dtype}")
        return torch.stack(self._home(xs))

    def _reduce(self, xs, op: str) -> torch.Tensor:
        with self.on(0):
            x = self._stack(xs)
            x = x.sum(0) if op == "sum" else x.amin(0) if op == "min" else x.amax(0)
            if not self.processes:
                return x
            y = x.to(self.comm_device)
            dist.all_reduce(y, op=getattr(dist.ReduceOp, _OPS[op]))
            return y.to(self.device)

    def psum(self, xs) -> torch.Tensor:
        return self._reduce(xs, "sum")

    def pmin(self, xs) -> torch.Tensor:
        return self._reduce(xs, "min")

    def pmax(self, xs) -> torch.Tensor:
        return self._reduce(xs, "max")

    def all_gather(self, xs) -> torch.Tensor:
        """(D, ...) with shard s's value in row s, on card 0."""
        with self.on(0):
            x = self._stack(xs)
        if not self.processes:
            return x
        return self.gather_blocks(x).flatten(0, 1)

    def gather_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(world, *x.shape): every rank's ``x`` (at least 1-D, the same
        shape and dtype on every rank), rank-major, on the mesh's device."""
        with self.on(0):
            y = x.to(self.comm_device).contiguous()
            out = torch.empty((self.world * y.shape[0],) + tuple(y.shape[1:]),
                              dtype=y.dtype, device=self.comm_device)
            dist.all_gather_into_tensor(out, y)
            return out.view((self.world,) + tuple(y.shape)).to(self.device)

    def read_gathered(self, xs, local) -> np.ndarray:
        """``all_gather(xs)``, (D, ...), followed by this process's ``local``
        values, (L, ...), read on the host in one copy (``TRANSPORT``
        counts it in ``host_reads``; the read is the span
        ``rdst.sync.read_gathered``).  Under NCCL this is the one host wait
        of a cross-process exchange."""
        gathered = self.all_gather(xs)
        with self.on(0):
            both = torch.cat([gathered, torch.stack(self._home(local))])
            TRANSPORT["host_reads"] += 1
            with span("sync.read_gathered"):
                return both.cpu().numpy()

    def all_to_all(self, send: torch.Tensor, send_counts, recv_counts) -> torch.Tensor:
        """One ``all_to_all_single`` of a 1-D int32 buffer on the
        communicator's device (:attr:`comm_device`, where the caller staged
        every card's words): ``send_counts[q]`` words to rank q, in rank
        order; returns the words received, ``recv_counts[p]`` from rank p, on
        card 0, on its stream.  Under gloo with CUDA cards both buffers cross
        the host (``TRANSPORT`` counts it)."""
        if send.device != self.comm_device:
            raise ValueError(f"stage the send buffer on {self.comm_device}, "
                             f"not {send.device}")
        with self.on(0):
            recv = torch.empty(sum(recv_counts), dtype=send.dtype, device=self.comm_device)
            if self.comm_device != self.device:
                TRANSPORT["host_copy_bytes"] += 4 * (send.numel() + recv.numel())
            dist.all_to_all_single(recv, send, list(recv_counts), list(send_counts))
            TRANSPORT["calls"] += 1
            TRANSPORT["bytes_sent"] += 4 * send.numel()
            TRANSPORT["bytes_received"] += 4 * recv.numel()
            return recv.to(self.device)


#: What the cross-process exchange moved: ``calls`` (all_to_all_single),
#: ``bytes_sent`` and ``bytes_received`` (payload words x 4),
#: ``host_copy_bytes`` (gloo's copies of the transport to and from the CPU),
#: ``host_reads`` (:meth:`Mesh.read_gathered`: the size matrix, one read per
#: cross-process exchange).  Never cleared here.
TRANSPORT: dict[str, int] = dict.fromkeys(
    ("calls", "bytes_sent", "bytes_received", "host_copy_bytes", "host_reads"), 0)


def init_distributed(*, backend: str | None = None, device="cuda",
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, **kwargs) -> None:
    """Start the default process group for meshes that span processes (one
    process per card, or per host with the host's cards in the mesh's
    ``devices``, or per CPU rank): the counterpart of
    ``jax.distributed.initialize``.

    Rank, world size and address come from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, read by
    ``init_method="env://"``), or from the arguments.  The backend is
    ``nccl`` for ``device="cuda"`` and ``gloo`` for ``"cpu"`` unless
    ``backend`` says otherwise; on CUDA the process takes card
    ``LOCAL_RANK`` (default 0), which under NCCL must be the first card of
    every mesh it builds (a rank of several cards: ``LOCAL_RANK`` 0 and
    ``devices`` from card 0).  Other keywords go to
    ``torch.distributed.init_process_group``.  A second call is a no-op."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA is not available (pass device='cpu')")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=-1 if rank is None else rank,
        world_size=-1 if world_size is None else world_size, **kwargs)


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _devices(device, devices):
    """Checks ``devices`` (or ``[device]`` where it is None): one type, CPU
    or CUDA, and CUDA present.  Returns ``devices`` as torch devices, or
    None."""
    devs = [torch.device(d) for d in ([device] if devices is None else devices)]
    types = {d.type for d in devs}
    if len(types) != 1 or not types <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh's cards are all CUDA or all CPU, got {devs}")
    if "cuda" in types and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available (pass device='cpu')")
    return None if devices is None else devs


def make_mesh(n_shards: int, axis: str = "shard", *, device="cuda",
              devices=None) -> Mesh:
    """A 1-axis mesh of ``n_shards`` shards on ``device``, or on the cards
    ``devices`` (a block of shards each), spread over the processes of
    :func:`init_distributed` where there are several (each process's block
    over its own ``devices``)."""
    devs = _devices(device, devices)
    return Mesh((n_shards,), (axis,), torch.device(device), devs)


def make_mesh_2d(n_hosts: int, chips_per_host: int,
                 axes: tuple[str, str] = ("host", "chip"), *,
                 device="cuda", devices=None) -> Mesh:
    """Two-axis mesh: ``axes[0]`` spans hosts, ``axes[1]`` the chips of a
    host; flat shard ``h * chips_per_host + c`` is (h, c).  Over
    ``n_hosts`` processes each holds one host row (on its ``devices``,
    split over them in order); in one process with ``devices`` of
    ``n_hosts`` cards each card holds one."""
    devs = _devices(device, devices)
    return Mesh((n_hosts, chips_per_host), axes, torch.device(device), devs)
