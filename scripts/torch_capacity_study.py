"""Capacity-factor study of the PyTorch port's distributed shuffle:
``scripts/capacity_study.py`` on ``rdst_tpu_torch.parallel``.

Measures, per input distribution on a mesh of 8 shards, the per-shard
DEMAND ratio max(counts)/n_local (the least ``capacity_factor`` that would
have fit) for the 1-axis ``make_mesh(8)`` and the 2-axis
``make_mesh_2d(2, 4)``, and the stage-1 headroom the 2-axis exchange needs:
the least ``config.hier_stage1_headroom`` at which no shard overflows,
shown by ``gather_valid``'s ``OverflowError``.  Every sort that fits is
checked against ``np.sort`` of its input.  The table is a finding: it
changes no default (``capacity_factor=1.5``, the headroom 1.5).

Beside capacity_study.py's seven distributions it has one where two
buckets are hot: two keys, each on 44% of the rows, in the ranges of
different shards.

    python scripts/torch_capacity_study.py             # on the card, N = 2^23
    python scripts/torch_capacity_study.py --device cpu --n 4096
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from rdst_tpu_torch import config  # noqa: E402
from rdst_tpu_torch.parallel import (  # noqa: E402
    distributed_sort,
    gather_valid,
    make_mesh,
    make_mesh_2d,
)

D = 8
N = 1 << 23  # 2^20 rows a shard


def _u64_planes(x):
    x = x.astype(np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return [hi, lo]


def distributions(rng, n):
    """capacity_study.py's seven distributions of ``n`` u64 keys (the same
    draws from ``rng``), then the two-hot-bucket one."""
    uni = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    shift = np.uint64(32)
    bimodal = np.concatenate(
        [uni[: n // 2] >> shift, uni[n // 2 :] << shift]
    )
    rng.shuffle(bimodal)
    z = np.minimum(rng.zipf(1.2, size=n), 1 << 20).astype(np.uint64)
    hot = rng.integers(0, 1 << 8, size=n, dtype=np.uint64)
    hot[: n // 8] = uni[: n // 8]
    # two keys far apart (a quarter and three quarters of the key range),
    # each on 44% of the rows, the other 12% uniform
    two = uni.copy()
    k = int(n * 0.44)
    two[:k] = np.uint64(1 << 62)
    two[k:2 * k] = np.uint64(3 << 62)
    rng.shuffle(two)
    return {
        "uniform": uni,
        "bimodal_s32": bimodal,
        "zipf_1.2": z,
        "low_entropy_16b": uni % np.uint64(1 << 16),
        "sorted_uniform": np.sort(uni),
        "all_equal": np.full(n, 42, dtype=np.uint64),
        "hot_multikey_88pct": hot,
        "two_hot_keys_44pct_each": two,
    }


def _check(x, words, counts, mesh):
    got = gather_valid(words, counts)
    want = _u64_planes(np.sort(x))
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise SystemExit(f"the shuffle on {mesh.shape} differs from np.sort")


def demand_ratio(x, mesh, axis):
    """max(counts)/n_local with a roomy buffer (nothing overflows)."""
    words, _, counts = distributed_sort(
        _u64_planes(x), mesh=mesh, axis=axis, capacity_factor=float(D)
    )
    _check(x, words, counts, mesh)
    c = counts.cpu().numpy()
    return float(c.max()) * D / len(x)


def stage1_headroom_needed(x, mesh2, factor):
    """Smallest hier_stage1_headroom in {1.0, 1.25, ... 8.0} that avoids a
    stage-1 overflow at the given final capacity_factor."""
    old = config.hier_stage1_headroom
    try:
        for h in [1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0]:
            config.hier_stage1_headroom = h
            words, _, counts = distributed_sort(
                _u64_planes(x), mesh=mesh2, axis=mesh2.axis_names,
                capacity_factor=factor,
            )
            try:
                gather_valid(words, counts)
            except OverflowError:
                continue
            _check(x, words, counts, mesh2)
            return h
        return float("inf")
    finally:
        config.hier_stage1_headroom = old


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=N,
                    help="keys in all (capacity_study.py: 2^15)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    rng = np.random.default_rng(0xCAFE)
    mesh1 = make_mesh(D, device=args.device)
    mesh2 = make_mesh_2d(2, D // 2, device=args.device)
    print(f"| distribution | demand 1-axis | demand (2,4) | "
          f"stage-1 headroom @1.25x final |")
    print("|---|---|---|---|")
    for name, x in distributions(rng, args.n).items():
        r1 = demand_ratio(x, mesh1, "shard")
        r2 = demand_ratio(x, mesh2, mesh2.axis_names)
        f = max(1.25, 1.1 * r2)
        h = stage1_headroom_needed(x, mesh2, f)
        print(f"| {name} | {r1:.3f} | {r2:.3f} | {h} (final f={f:.2f}) |",
              flush=True)


if __name__ == "__main__":
    main()
