#!/usr/bin/env python3
"""Where the time of the port's distributed sort goes, on one CUDA card.

Sorts 2^28 u64 keys with a u32 payload, stable, over ``make_mesh(8)`` (8
shards of 2^25 rows on one card, the size ``chip_smoke.py`` drives), made
on the card from a seed.  For the sequential exchange and the overlapped
one: the first call and a warm one on the host clock (one synchronize at
the end of each), then one more warm call inside a profiler region, split
by the port's own spans (``scripts/torch_span_split.py``):

  rdst.shuffle.sort.* [local]    each shard's sort before the exchange
                                 (``fused``: B8 or B2/B3 under ``rdst.fused_sort``;
                                 ``lex``: ``lex_sort``);
  rdst.shuffle.plan              windows, histograms, the assignment;
  rdst.shuffle.exchange          layout, pad fill, B6;
  rdst.shuffle.sort.* [finish]   each shard's sort after the exchange;
  rdst.shuffle, own              the rest of the call: the write-backs and
                                 the overlapped path's merges, whose B4 and
                                 B5 kernels have lines of their own.

Run from the checkout root:

    python3 scripts/torch_shuffle_stages.py [--log2-rows 25] [--shards 8] [--root DIR]

``--root`` imports the package of another checkout (the parent's, for
``scripts/torch_bitonic_ab.py``); it must have the same module layout and
record the same spans.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch_span_split as tss

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-rows", type=int, default=25, help="rows per shard, log2")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose rdst_tpu_torch runs")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_shuffle_stages: CUDA is not available", file=sys.stderr)
        return 2
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch import parallel as par

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    D = args.shards
    n = D << args.log2_rows
    hi, lo = [P.narrow(torch.randint(0, 1 << 32, (n,), generator=gen, device=dev),
                       torch.uint32) for _ in range(2)]
    pay = P.arange(n, torch.uint32, dev)
    mesh = par.make_mesh(D, device=dev)
    print(f"device: {torch.cuda.get_device_name(0)}; {n} rows over {D} shards")

    for label, overlap in (("sequential", False), ("overlapped", True)):
        def call():
            return par.distributed_sort([hi, lo], [pay], mesh=mesh, stable=True,
                                        overlap_exchange=overlap)

        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del out
        print(f"{label}: first call {times[0]:.2f} ms, warm call {times[1]:.2f} ms "
              f"(host clock); peak {torch.cuda.max_memory_allocated()} B")
        out, wall, trace = tss.record(call, str(ROOT / "build" / "stage_traces"))
        del out
        tss.report(label, trace, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
