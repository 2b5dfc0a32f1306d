#!/usr/bin/env python3
"""Where the time of the port's distributed table operators goes, on one
CUDA card.

Makes ``chip_smoke.py``'s TPC-H-shaped tables on the card (``tpch_tables``:
LINEITEM 2^26 rows, ORDERS 2^24, from a seed) and runs, over
``make_mesh(8)``, the paths of its table phase that shuffle: Q18's inner
aggregate (hash and range partitioned), the lineitem-orders join (hash) and
the ORDER BY of orders.  Each path runs once to warm up, once with a
synchronize around each stage, host clock:

  encode        ``dtable._encode_table`` and the key hash;
  local sorts   the shuffle's sorts before its exchange, split by route
                (B2/B3 or ``lex_sort``);
  exchange      ``shuffle._exchange_raw`` (B6);
  finish sorts  the shuffle's sorts after its exchange, split by route;
  shuffle rest  the rest of ``distributed_sort`` / ``partition_exchange``
                (windows, histograms, the assignment, write-backs);
  aggregate     ``dtable._agg_local`` and ``_agg_combine``;
  join          ``dtable._join_local``;
  densify       ``dtable._dense``;
  the rest      the call less those (decode, denormalize, host reads);

then once under ``torch.profiler``: its wall time, the device time summed
over its kernels (the rest of the wall is the device's idle share), and
the kernels that took the most.

Run from the checkout root:

    python3 scripts/torch_table_stages.py [--log2-lineitem 26] [--seed 7]
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-lineitem", type=int, default=26,
                    help="lineitem rows, log2 (orders: a quarter of them)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_table_stages: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    import rdst_tpu_torch as rt
    from rdst_tpu_torch import parallel as par
    from rdst_tpu_torch.parallel import dtable as dt
    from rdst_tpu_torch.parallel import shuffle as sh

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n_l = 1 << args.log2_lineitem
    lineitem, orders, _, sf = chip_smoke.tpch_tables(torch, dev, gen, n_l, n_l // 4)
    li, od = rt.Table(lineitem), rt.Table(orders)
    mesh = par.make_mesh(8, device=dev)
    print(f"device: {torch.cuda.get_device_name(0)}; TPC-H shape SF {sf:.2f}: "
          f"lineitem {n_l} rows, orders {n_l // 4}; 8 shards")
    aggs = {"sum_qty": ("quantity", "sum"), "n": ("quantity", "count"),
            "avg_qty": ("quantity", "mean"), "max_price": ("extendedprice", "max")}
    paths = [
        ("group_aggregate hash", n_l, lambda: par.distributed_group_aggregate(
            li, "orderkey", aggs, mesh=mesh, partition="hash")),
        ("group_aggregate range", n_l, lambda: par.distributed_group_aggregate(
            li, "orderkey", aggs, mesh=mesh, partition="range")),
        ("join hash", n_l + n_l // 4, lambda: par.distributed_join(
            li, od, "orderkey", mesh=mesh, partition="hash")),
        ("sort_table orders by totalprice", n_l // 4, lambda: par.distributed_sort_table(
            od, "totalprice", mesh=mesh, stable=True)),
    ]

    acc: dict[str, float] = {}
    phase = ["local sorts"]

    def timed(fn, name_of):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            name = name_of(*a)
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    routes_seen = collections.Counter()

    def route(*_):
        """The route of the sort that just ran, as ``_local_sort`` recorded
        it in ``SORT_ROUTES``."""
        (n_planes, _, by), = sh.SORT_ROUTES - routes_seen
        routes_seen.update(sh.SORT_ROUTES - routes_seen)
        return f"{phase[0]} ({n_planes} planes, {by})"

    def shuffle_entry(fn):
        inner = timed(fn, lambda *a: "shuffle")

        def wrapper(*a, **k):
            phase[0] = "local sorts"
            return inner(*a, **k)
        return wrapper

    def exchange(fn):
        inner = timed(fn, lambda *a: "exchange")

        def wrapper(*a, **k):
            out = inner(*a, **k)
            phase[0] = "finish sorts"
            return out
        return wrapper

    patches = [
        (sh, "_local_sort", lambda f: timed(f, route)),
        (sh, "_exchange_raw", exchange),
        (dt, "distributed_sort", shuffle_entry),
        (dt, "partition_exchange", shuffle_entry),
        (dt, "_encode_table", lambda f: timed(f, lambda *a: "encode")),
        (dt, "_hash_plane", lambda f: timed(f, lambda *a: "encode")),
        (dt, "_agg_local", lambda f: timed(f, lambda *a: "aggregate")),
        (dt, "_agg_combine", lambda f: timed(f, lambda *a: "aggregate")),
        (dt, "_join_local", lambda f: timed(f, lambda *a: "join")),
        (dt, "_dense", lambda f: timed(f, lambda *a: "densify")),
    ]
    real = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, rows, fn in paths:
        out = fn()
        torch.cuda.synchronize()
        del out
        acc.clear()
        sh.SORT_ROUTES.clear()
        routes_seen.clear()
        for (mod, name, wrap), (_, _, f) in zip(patches, real):
            setattr(mod, name, wrap(f))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            for mod, name, f in real:
                setattr(mod, name, f)
        del out
        inside = sum(v for k, v in acc.items() if k != "shuffle")
        shuffle_parts = sum(v for k, v in acc.items() if "sorts" in k or k == "exchange")
        acc["shuffle rest"] = acc.pop("shuffle", 0.0) - shuffle_parts
        rest = total - inside - acc["shuffle rest"]
        parts = "; ".join(f"{k} {v * 1e3:.2f} ms ({v / total:.1%})" for k, v in acc.items())
        print(f"{label}: total {total * 1e3:.2f} ms ({rows / total:,.0f} rows/s) with "
              f"a synchronize around each stage; {parts}; the rest {rest * 1e3:.2f} ms "
              f"({rest / total:.1%})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        del out
        ka = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ka
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
        print(f"{label}, profiled call: wall {wall:.2f} ms; device time summed over "
              f"kernels {busy:.2f} ms; idle share {1 - busy / wall:.3f}")
        print(ka.table(sort_by="self_device_time_total", row_limit=10,
                       max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
