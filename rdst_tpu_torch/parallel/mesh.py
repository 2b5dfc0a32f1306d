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
mesh holds every shard and calls nothing.

The collectives reduce over every shard of the mesh (the shuffle's body
reduces over its whole partition axis, a tuple of both axes on a 2-axis
mesh); :meth:`Mesh.groups` names the shards that exchange along one axis
of a 2-axis mesh.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "init_distributed", "make_mesh", "make_mesh_2d"]

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


class Mesh:
    """``shape`` shards (row-major over ``axis_names``) on one device of
    each process, spread over the default process group's ranks where it
    has more than one."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        self.shape = tuple(int(x) for x in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or min(self.shape) < 1:
            raise ValueError(f"bad mesh shape {self.shape} for {self.axis_names}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.size = 1
        for x in self.shape:
            self.size *= x
        self.processes = (dist.is_available() and dist.is_initialized()
                          and dist.get_world_size() > 1)
        self.rank, self.world = 0, 1
        self.comm_device = self.device
        if self.processes:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            if self.size % self.world:
                raise ValueError(f"{self.size} shards do not split evenly over "
                                 f"{self.world} processes")
            if dist.get_backend() != "nccl":
                self.comm_device = torch.device("cpu")
        self.n_local = self.size // self.world

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
        if len(xs) != self.n_local:
            raise ValueError(f"{len(xs)} values for {self.n_local} shards")
        if self.processes:
            for x in xs:
                if x.dtype != torch.int64:
                    raise TypeError(f"collectives carry int64, got {x.dtype}")
        return torch.stack(list(xs))

    def _reduce(self, xs, op: str) -> torch.Tensor:
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
        """(D, ...) with shard s's value in row s."""
        x = self._stack(xs)
        if not self.processes:
            return x
        return self.gather_blocks(x).flatten(0, 1)

    def gather_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(world, *x.shape): every rank's ``x`` (at least 1-D, the same
        shape and dtype on every rank), rank-major, on the mesh's device."""
        y = x.to(self.comm_device).contiguous()
        out = torch.empty((self.world * y.shape[0],) + tuple(y.shape[1:]),
                          dtype=y.dtype, device=self.comm_device)
        dist.all_gather_into_tensor(out, y)
        return out.view((self.world,) + tuple(y.shape)).to(self.device)

    def read_gathered(self, xs, local) -> np.ndarray:
        """``all_gather(xs)``, (D, ...), followed by this process's ``local``
        values, (L, ...), read on the host in one copy (``TRANSPORT``
        counts it in ``host_reads``).  Under NCCL this is the one host wait
        of a cross-process exchange."""
        both = torch.cat([self.all_gather(xs), torch.stack(list(local))])
        TRANSPORT["host_reads"] += 1
        return both.cpu().numpy()

    def all_to_all(self, send: torch.Tensor, send_counts, recv_counts) -> torch.Tensor:
        """One ``all_to_all_single`` of a 1-D int32 buffer: ``send_counts[q]``
        words to rank q, in rank order; returns the words received,
        ``recv_counts[p]`` from rank p, on the mesh's device.  Under gloo
        both buffers cross to the CPU and back (``TRANSPORT`` counts it)."""
        recv = torch.empty(sum(recv_counts), dtype=send.dtype, device=self.comm_device)
        if self.comm_device != send.device:
            TRANSPORT["host_copy_bytes"] += 4 * (send.numel() + recv.numel())
        dist.all_to_all_single(recv, send.to(self.comm_device),
                               list(recv_counts), list(send_counts))
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
    process per card, or per CPU rank): the counterpart of
    ``jax.distributed.initialize``.

    Rank, world size and address come from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, read by
    ``init_method="env://"``), or from the arguments.  The backend is
    ``nccl`` for ``device="cuda"`` and ``gloo`` for ``"cpu"`` unless
    ``backend`` says otherwise; on CUDA the process takes card
    ``LOCAL_RANK`` (default 0).  Other keywords go to
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


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available (pass device='cpu')")
    return dev


def make_mesh(n_shards: int, axis: str = "shard", *, device="cuda") -> Mesh:
    """A 1-axis mesh of ``n_shards`` shards on ``device``, spread over the
    processes of :func:`init_distributed` where there are several."""
    return Mesh((n_shards,), (axis,), _device(device))


def make_mesh_2d(n_hosts: int, chips_per_host: int,
                 axes: tuple[str, str] = ("host", "chip"), *,
                 device="cuda") -> Mesh:
    """Two-axis mesh: ``axes[0]`` spans hosts, ``axes[1]`` the chips of a
    host; flat shard ``h * chips_per_host + c`` is (h, c).  Over
    ``n_hosts`` processes each holds one host row.  A process's shards lie
    on one ``device``: shards on several cards of one process need
    peer-mapped exchange buffers, which are later work."""
    return Mesh((n_hosts, chips_per_host), axes, _device(device))
