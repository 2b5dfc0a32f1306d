#!/usr/bin/env python3
"""Where the time of the port's distributed table operators goes, on one
CUDA card.

Makes TPC-H's LINEITEM and ORDERS on the card with the generator of the
benchmark's TPC-H cell (``benchmark/reference/tpch_queries.py``: orders
2^24 rows at SF 2^24 / 1.5M, about 4 lines an order), four columns each
(lineitem: orderkey, quantity, extendedprice, shipdate; orders: orderkey,
custkey, totalprice, orderdate), the lines in a random order (a table
partitioned without regard to its key), and runs, over ``make_mesh(8)``,
the table paths that shuffle: Q18's inner aggregate (hash and range
partitioned), the lineitem-orders join (hash) and the ORDER BY of orders.
Each path runs once to warm up, once timed on the host clock (one
synchronize at its end), and once inside a profiler region, split by the
port's own spans (``scripts/torch_span_split.py``):

  rdst.table.encode              the key and payload encoding;
  rdst.shuffle.sort.* [local]    the shuffle's sorts before its exchange,
                                 by route (``fused``: B8 or B2/B3; ``lex``);
  rdst.shuffle.plan              windows, histograms, the assignment;
  rdst.shuffle.exchange          B6;
  rdst.shuffle.sort.* [finish]   the sorts after the exchange, by route;
  rdst.shuffle, own              the rest of the shuffle (write-backs);
  rdst.table.aggregate           the segment reductions and the combine;
  rdst.table.join                every shard's sort-merge join;
  rdst.table.densify             the valid rows made dense;
  rdst.sync.*                    the host reads;
  outside every span             the rest (decode, denormalize).

Run from the checkout root:

    python3 scripts/torch_table_stages.py [--log2-lineitem 26] [--seed 7]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch_span_split as tss

ROOT = Path(__file__).resolve().parent.parent


def tables(torch, dev, n_orders: int, seed: int):
    """(lineitem, orders) as dicts of columns on ``dev``."""
    sys.path.insert(0, str(ROOT / "benchmark" / "reference"))
    import tpch_queries as ref

    sf = n_orders / ref.ORDERS_PER_SF
    li, od, _ = ref.generate(sf, 1, 1, seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    order = torch.randperm(li["l_orderkey"].shape[0], generator=gen, device=dev)
    lineitem = {"orderkey": li["l_orderkey"][order],
                "quantity": (li["l_quantity"] // 100).to(torch.int32)[order],
                "extendedprice": li["l_extendedprice"][order],
                "shipdate": li["l_shipdate"][order]}
    orders = {"orderkey": od["o_orderkey"], "custkey": od["o_custkey"].to(torch.int32),
              "totalprice": od["o_totalprice"], "orderdate": od["o_orderdate"]}
    return lineitem, orders, sf


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-lineitem", type=int, default=26,
                    help="about the lineitem rows, log2 (orders: a quarter of them)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_table_stages: CUDA is not available", file=sys.stderr)
        return 2
    import rdst_tpu_torch as rt
    from rdst_tpu_torch import parallel as par

    dev = torch.device("cuda", 0)
    lineitem, orders, sf = tables(torch, dev, 1 << (args.log2_lineitem - 2), args.seed)
    n_l, n_o = int(lineitem["orderkey"].shape[0]), int(orders["orderkey"].shape[0])
    li, od = rt.Table(lineitem), rt.Table(orders)
    mesh = par.make_mesh(8, device=dev)
    print(f"device: {torch.cuda.get_device_name(0)}; TPC-H SF {sf:.4f}: lineitem {n_l} "
          f"rows, orders {n_o}; 8 shards")
    aggs = {"sum_qty": ("quantity", "sum"), "n": ("quantity", "count"),
            "avg_qty": ("quantity", "mean"), "max_price": ("extendedprice", "max")}
    paths = [
        ("group_aggregate hash", n_l, lambda: par.distributed_group_aggregate(
            li, "orderkey", aggs, mesh=mesh, partition="hash")),
        ("group_aggregate range", n_l, lambda: par.distributed_group_aggregate(
            li, "orderkey", aggs, mesh=mesh, partition="range")),
        ("join hash", n_l + n_o, lambda: par.distributed_join(
            li, od, "orderkey", mesh=mesh, partition="hash")),
        ("sort_table orders by totalprice", n_o, lambda: par.distributed_sort_table(
            od, "totalprice", mesh=mesh, stable=True)),
    ]
    for label, rows, fn in paths:
        out = fn()
        torch.cuda.synchronize()
        del out
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        del out
        print(f"{label}: warm call {warm * 1e3:.2f} ms ({rows / warm:,.0f} rows/s, host "
              "clock)")
        out, wall, trace = tss.record(fn, str(ROOT / "build" / "stage_traces"))
        del out
        tss.report(label, trace, wall, top=6)
    return 0


if __name__ == "__main__":
    sys.exit(main())
