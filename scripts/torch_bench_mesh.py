"""Mesh scaling harness of the PyTorch port: ``scripts/bench_mesh.py`` on
``rdst_tpu_torch.parallel``: distributed shuffle-sort throughput against
the number of shards.

For each D in {1, 2, 4, 8} it weak-scales the input (n = per_device * D),
runs ``distributed_sort`` (local sorts, the partition, the exchange through
kernel B6, the finish sorts) on ``make_mesh(D)``, and reports rows/s and
the efficiency against D = 1; then the 2-axis (2, 4) exchange of
``make_mesh_2d(2, 4)``.  Each call is timed on the host clock up to a
``torch.cuda.synchronize()``, and the last call's output is checked against
``torch.sort`` of its input.

By default a mesh holds all its shards on ONE device: on one card the D
shards share the card, so ``weak_scaling_efficiency_vs_D1`` measures what
the mesh costs a shard, not scaling over cards.  ``--cards K`` spreads each
mesh over min(D, K) card entries (``make_mesh(D, devices=...)``), as the
reference's ``make_mesh(D)`` takes one device a shard: the machine's cards
in turn, an entry repeating a card where K exceeds them (on one card, K
streams of it); on the CPU, K CPU entries.  Ranks on one card each are not
run here (NCCL refuses two ranks on one card).

    python scripts/torch_bench_mesh.py --per-device 16777216   # on the card
    python scripts/torch_bench_mesh.py --per-device 16777216 --cards 8
    python scripts/torch_bench_mesh.py --device cpu --per-device 4096

Prints one JSON line per mesh (bench_mesh.py's fields).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rdst_tpu_torch import _planes as P  # noqa: E402
from rdst_tpu_torch.parallel import distributed_sort, make_mesh, make_mesh_2d  # noqa: E402
from scripts.torch_bench_suite import check_sorted  # noqa: E402

LADDER = (1, 2, 4, 8)


def valid_rows(planes, counts):
    """Each shard's valid rows, concatenated in shard order, on the device
    of the counts (a per-card plane's blocks joined there first)."""
    c = counts.cpu().tolist()
    if any(k < 0 for k in c):
        raise SystemExit(f"negative counts {c}")
    out = []
    for p in planes:
        if isinstance(p, list):
            p = P.cat([b.to(counts.device) for b in p])
        cap = p.shape[0] // len(c)
        if max(c) > cap:
            raise SystemExit(f"a shard received {max(c)} rows > capacity {cap}")
        out.append(P.cat([p[d * cap: d * cap + k] for d, k in enumerate(c)]))
    return out


def bench(mesh, axis, words, iters, dev):
    """Seconds per call of the unstable u64 shuffle, after one warm call;
    the last call's output is checked."""
    def run():
        w, _, c = distributed_sort(words, [], mesh=mesh, axis=axis,
                                   capacity_factor=2.0, stable=False)
        if dev.type == "cuda":
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
        return w, c

    run()
    t0 = time.perf_counter()
    for _ in range(iters):
        w, c = run()
    dt = (time.perf_counter() - t0) / iters
    check_sorted(f"the shuffle on {mesh.shape}", words, [], 8, False,
                 valid_rows(w, c), [])
    return dt


def row(metric, rows_s, eff, D):
    print(json.dumps({
        "metric": metric,
        "value": round(rows_s),
        "unit": "rows/s",
        "vs_baseline": round(eff, 4),
        "devices": D,
        "weak_scaling_efficiency_vs_D1": round(eff, 4),
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--per-device", type=int, default=1 << 20,
                    help="rows a shard")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--cards", type=int, default=1,
                    help="card entries a mesh spreads over (1: one device)")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and torch.cuda.is_available():
        entries = [f"cuda:{i % torch.cuda.device_count()}" for i in range(args.cards)]
    else:
        entries = [args.device] * args.cards

    def cards(D):
        """The first min(D, K) entries, or None for one device."""
        return None if args.cards == 1 else entries[:min(D, args.cards)]

    rng = np.random.default_rng(0)
    base = None

    def words_of(n, dev):
        return [
            torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.int64)
                             .astype(np.uint32)).to(dev)
            for _ in range(2)
        ]

    for D in LADDER:
        mesh = make_mesh(D, device=args.device, devices=cards(D))
        n = args.per_device * D
        words = words_of(n, mesh.device)
        rows_s = n / bench(mesh, "shard", words, args.iters, mesh.device)
        if base is None:
            base = rows_s
        eff = rows_s / (base * D)
        row(f"dist_shuffle_rows_per_s_D{D}", rows_s, eff, D)
        del words

    # 2-axis (host x chip) hierarchical exchange: the multi-host code shape
    H, C = 2, 4
    mesh2 = make_mesh_2d(H, C, device=args.device, devices=cards(H * C))
    D = H * C
    n = args.per_device * D
    words = words_of(n, mesh2.device)
    rows_s = n / bench(mesh2, mesh2.axis_names, words, args.iters, mesh2.device)
    eff = rows_s / (base * D)
    row(f"dist_shuffle_rows_per_s_hier_{H}x{C}", rows_s, eff, D)


if __name__ == "__main__":
    main()
