"""A mesh of shards in one process: the counterpart of ``jax.sharding.Mesh``.

The JAX package runs the shuffle inside ``shard_map``: one program per
device, with collectives (``psum``, ``pmin``, ``pmax``, ``all_gather``,
``axis_index``) between them.  Here every shard lives in this process and
the shard body runs in lockstep: a per-shard value is a list over the
mesh's shards, and the collectives are functions of such lists.  Any number
of shards may share one device, so a mesh of 8 shards on one H100 runs the
shuffle's real all-to-all traffic (HBM to HBM) and the CPU tests run the
same code as the JAX package's virtual 8-device mesh.

The collectives reduce over every shard of the mesh (the shuffle's body
reduces over its whole partition axis, a tuple of both axes on a 2-axis
mesh) and return one replicated tensor; :meth:`Mesh.groups` names the
shards that exchange along one axis of a 2-axis mesh.  These methods are
the interface a multi-process backend (``torch.distributed``, one shard per
process) would implement: there ``shards`` holds the process's own shard
and the collectives call ``all_reduce`` and ``all_gather``.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["Mesh", "make_mesh", "make_mesh_2d"]


class Mesh:
    """``shape`` shards (row-major over ``axis_names``) on one device."""

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

    @property
    def shards(self) -> range:
        """Flat indices (row-major, host-major on a 2-axis mesh) of the
        shards this process holds: all of them."""
        return range(self.size)

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
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} values for {self.size} shards")
        return torch.stack(list(xs))

    def psum(self, xs) -> torch.Tensor:
        return self._stack(xs).sum(0)

    def pmin(self, xs) -> torch.Tensor:
        return self._stack(xs).amin(0)

    def pmax(self, xs) -> torch.Tensor:
        return self._stack(xs).amax(0)

    def all_gather(self, xs) -> torch.Tensor:
        """(D, ...) with shard s's value in row s."""
        return self._stack(xs)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available (pass device='cpu')")
    return dev


def make_mesh(n_shards: int, axis: str = "shard", *, device="cuda") -> Mesh:
    """A 1-axis mesh of ``n_shards`` shards, all on ``device``."""
    return Mesh((n_shards,), (axis,), _device(device))


def make_mesh_2d(n_hosts: int, chips_per_host: int,
                 axes: tuple[str, str] = ("host", "chip"), *,
                 device="cuda") -> Mesh:
    """Two-axis mesh: ``axes[0]`` spans hosts, ``axes[1]`` the chips of a
    host; flat shard ``h * chips_per_host + c`` is (h, c).  All shards on
    ``device``: shards on several cards need peer-mapped exchange buffers,
    which are later work."""
    return Mesh((n_hosts, chips_per_host), axes, _device(device))
