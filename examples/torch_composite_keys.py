"""Multi-field composite keys and table sorting on the PyTorch port
(reference: examples/impl_radix_key.rs, multi-key orderings over struct
fields).

    python examples/torch_composite_keys.py [--device cuda|cpu]
"""
import argparse

import numpy as np

import rdst_tpu_torch as rt
from rdst_tpu_torch.table import Table

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(0)
n = 100_000

# sort by (category, score): a two-field key
cat = rng.integers(0, 500, n).astype(np.uint16)
score = rng.standard_normal(n).astype(np.float32)
(s_cat, s_score) = rt.radix_sort_unstable((cat, score), device=args.device)
print("composite-sorted:", s_cat[:3], s_score[:3])

# the same through the columnar table engine, with a payload column
t = Table({"cat": cat, "score": score, "id": np.arange(n, dtype=np.uint32)},
          device=args.device)
s = t.sort_by(["cat", "score"])
print(s)

agg, n_groups = t.group_aggregate(
    "cat", {"total": ("score", "sum"), "cnt": ("score", "count")}
)
print("groups:", int(n_groups))
