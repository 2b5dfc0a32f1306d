"""Row-batched sorting on the PyTorch port: many independent small sorts
at once (the reference's per-bucket parallel recursion, sorter.rs:121-139).

    python examples/torch_batched_rows.py [--device cuda|cpu]
"""
import argparse

import numpy as np

import rdst_tpu_torch as rt

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = args.device

rng = np.random.default_rng(0)

# 512 independent series of 1024 f32 scores with row-aligned ids
scores = rng.standard_normal((512, 1024)).astype(np.float32)
ids = np.broadcast_to(np.arange(1024, dtype=np.uint32), scores.shape).copy()

rows_sorted, (ids_sorted,) = rt.batched_sort(scores, [ids], stable=True, device=dev)
rows_sorted = rows_sorted.cpu().numpy()
assert np.array_equal(rows_sorted, np.sort(scores, axis=-1))
print("rows sorted:", rows_sorted[0, :4])

# per-row top-8 by score, ids gathered alongside
top, (top_ids,) = rt.batched_top_k(scores, 8, [ids], largest=True, device=dev)
top, top_ids = top.cpu().numpy(), top_ids.cpu().numpy()
want = np.sort(scores, axis=-1)[:, ::-1][:, :8]
assert np.array_equal(top, want)
print("row-0 top-8:", top[0])
print("row-0 top-8 ids:", top_ids[0])

# composite keys work too: sort rows by (group, priority) ascending
grp = rng.integers(0, 4, size=(64, 256)).astype(np.uint8)
pri = rng.integers(0, 1000, size=(64, 256)).astype(np.uint32)
(sg, sp), _ = rt.batched_sort((grp, pri), device=dev)
packed = np.rec.fromarrays([grp, pri])
want = np.sort(packed, axis=-1)
assert np.array_equal(sg.cpu().numpy(), want.f0)
assert np.array_equal(sp.cpu().numpy(), want.f1)
print("composite rows ok")
