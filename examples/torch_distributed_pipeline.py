"""Distributed table pipeline on the PyTorch port, over a mesh of 8 shards
on one device (the JAX package's BASELINE config 5).

Global sort, filter, group-aggregate and a co-partitioned join: the
generalization of the reference's bucket-exchange algorithms to a mesh
(reference: recombinating_sort.rs, regions_sort.rs).  On a card every
exchange is one launch of kernel B6.

    python examples/torch_distributed_pipeline.py [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

from rdst_tpu_torch.parallel import (
    distributed_filter,
    distributed_group_aggregate,
    distributed_join,
    distributed_sort_auto,
    distributed_sort_table,
    gather_valid,
    make_mesh,
)
from rdst_tpu_torch.table import Table

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

mesh = make_mesh(8, device=args.device)
D = mesh.size
n = 4096 * D
rng = np.random.default_rng(0)

facts = Table(
    {
        "sku": rng.integers(0, 256, n).astype(np.uint32),
        "qty": rng.integers(1, 20, n).astype(np.uint32),
        "ts": rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32),
    },
    device=args.device,
)
dims = Table(
    {
        "sku": np.arange(256, dtype=np.uint32),
        "price": (np.arange(256, dtype=np.uint32) * 3 + 10),
    },
    device=args.device,
)

# global ORDER BY ts
ordered, counts = distributed_sort_table(facts, "ts", mesh=mesh)
print("sorted rows per device:", counts.cpu().numpy())

# WHERE qty > 10 (local, no exchange)
kept, kcounts = distributed_filter(facts, facts["qty"].to(torch.int64) > 10, mesh=mesh)
print("filtered rows per device:", kcounts.cpu().numpy())

# GROUP BY sku: SUM(qty)
agg, n_groups = distributed_group_aggregate(
    facts, "sku", {"total_qty": ("qty", "sum")}, mesh=mesh
)
print("groups:", int(n_groups))

# JOIN facts x dims on sku (co-partitioned: both sides routed by the same
# range partition so that matching keys meet on one shard; the small dim
# side gets full-table capacity on every shard)
joined, n_matched = distributed_join(facts, dims, "sku", mesh=mesh)
assert int(n_matched) == n
price = joined["price"].cpu().numpy()
sku = joined["sku"].cpu().numpy()
assert np.array_equal(price, sku * 3 + 10)
print("joined rows:", int(n_matched))

# raw key sort with automatic overflow retry: skewed key masses balance
# through hot-bucket refinement; anything deeper doubles capacity to fit
zipf = np.minimum(rng.zipf(1.2, size=n), 1 << 20).astype(np.uint32)
words, _, zcounts = distributed_sort_auto(
    [torch.from_numpy(zipf).to(args.device)], mesh=mesh
)
assert np.array_equal(gather_valid(words, zcounts)[0], np.sort(zipf))
print("zipf sorted; max device load:",
      int(zcounts.max()), "of", n // D, "fair share")
