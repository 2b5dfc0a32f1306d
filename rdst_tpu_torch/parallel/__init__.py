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
version.  Several cards of one process, a block of shards each:

    mesh = make_mesh(8, devices=["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
    words, payloads, counts = distributed_sort([hi, lo], [pay], mesh=mesh)
    # words[0] is [card 0's block, ..., card 3's block], each on its card
    hi_s, lo_s, pay_s = gather_valid(words + payloads, counts)

Each card sorts on its own stream, and the exchange (kernel B6) launches
once per receiving card, reading the other cards' planes through peer
access, ordered by events.  Outputs are per card (the blocks, concatenated
in card order, are the one-card result; the table operators return one
Table a card); ``counts`` stays one tensor on the first card.  Entries may
repeat a card (``["cuda:0"] * 4``: four streams on one card, the cards'
code on a machine with one), and ``["cpu"] * 4`` runs the same grouping on
the host.  One process per card (or per CPU rank), under ``torchrun
--nproc_per_node=N``:

    init_distributed()                        # NCCL; gloo for device="cpu"
    mesh = make_mesh(8)                       # 8 // N shards in each process
    words, payloads, counts = distributed_sort([hi, lo], [pay], mesh=mesh)
    hi_s, lo_s, pay_s = gather_valid(words + payloads, counts, mesh=mesh)

Each process passes its own rows (its shards' share) and gets its shards'
planes with the global counts; ``gather_valid(..., mesh=mesh)`` returns the
whole order on every rank.  The table operators take the same convention:
each rank passes its own rows of every table and gets back its shards'
output (the static-length outputs of ``distributed_sort_table`` and
``distributed_filter`` with the global (D,) counts; the densified group or
join rows of its shards with the global group or match count), so the
ranks' outputs, concatenated rank by rank, are the one-process result.
``init_distributed(device="cpu", init_method="file:///tmp/rdv", rank=r,
world_size=n)`` starts gloo without torchrun.  A rank may hold several
cards, as each host of the JAX package's multi-host pod does: one process
per host under ``torchrun --nnodes=H --nproc_per_node=1``, each passing
its host's cards:

    init_distributed()                        # LOCAL_RANK 0: card 0 is current
    mesh = make_mesh_2d(H, 4, devices=["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
    words, payloads, counts = distributed_sort([hi, lo], [pay], mesh=mesh,
                                               axis=mesh.axis_names)

Card 0 of each rank carries the collectives (under NCCL it must be the
current device).  The outputs are per card as on one process: concatenated
rank by rank, and within a rank card by card, they are the one-process
result.
"""
from rdst_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh, make_mesh_2d
from rdst_tpu_torch.parallel.shuffle import (
    distributed_sort,
    distributed_sort_auto,
    gather_valid,
    partition_exchange,
)
from rdst_tpu_torch.parallel.dtable import (
    distributed_densify,
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
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "distributed_sort_table",
    "distributed_filter",
    "distributed_group_aggregate",
    "distributed_join",
    "distributed_densify",
]
