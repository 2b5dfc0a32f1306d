"""The distributed shuffle and table pipeline of ``rdst_tpu.parallel``
over a mesh of shards.

    from rdst_tpu_torch.parallel import make_mesh, distributed_sort, gather_valid
    mesh = make_mesh(8)                       # 8 shards on the current card
    words, payloads, counts = distributed_sort([hi, lo], [pay], mesh=mesh)
    hi_s, lo_s, pay_s = gather_valid(words + payloads, counts)
    out, n = distributed_group_aggregate(table, "k", {"s": ("v", "sum")},
                                         mesh=mesh, partition="hash")
    joined, n = distributed_join(fact, dim, "k", mesh=mesh)

``make_mesh(8, device="cpu")`` runs the same code with the exchange's plain
version.  ``init_distributed`` is not ported: it starts a multi-process
backend (one shard per process), which does not exist yet.  NCCL does not
allow two ranks of one communicator on one device, so such a backend cannot
run more than one rank on a machine with one card.
"""
from rdst_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
from rdst_tpu_torch.parallel.shuffle import (
    distributed_sort,
    distributed_sort_auto,
    gather_valid,
    partition_exchange,
)
from rdst_tpu_torch.parallel.dtable import (
    distributed_filter,
    distributed_group_aggregate,
    distributed_join,
    distributed_sort_table,
)

__all__ = [
    "Mesh",
    "distributed_sort",
    "distributed_sort_auto",
    "partition_exchange",
    "gather_valid",
    "make_mesh",
    "make_mesh_2d",
    "distributed_sort_table",
    "distributed_filter",
    "distributed_group_aggregate",
    "distributed_join",
]
