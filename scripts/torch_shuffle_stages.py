#!/usr/bin/env python3
"""Where the time of the port's distributed sort goes, on one CUDA card.

Sorts 2^28 u64 keys with a u32 payload, stable, over ``make_mesh(8)`` (8
shards of 2^25 rows on one card, the size ``chip_smoke.py`` drives), made
on the card from a seed.  Prints, for the sequential exchange (two calls:
cold, then warm) and the overlapped one, the host-clock time of each stage
with a synchronize around it:

  local sorts    ``shuffle._local_sort`` before the exchange (B2/B3);
  exchange       ``shuffle._exchange_raw``: layout, pad fill, B6 launches;
  finish sorts   ``shuffle._local_sort`` after the exchange (B2/B3);
  the rest       the call less those: windows, histograms, the assignment,
                 write-backs, and the overlapped path's B4/B5 merges, whose
                 launches and device time (CUDA events around each launch)
                 the overlapped line prints;

then one unwrapped call under ``torch.profiler``: its wall time, the device
time summed over its kernels, and the kernels that took the most.

Run from the checkout root:

    python3 scripts/torch_shuffle_stages.py [--log2-rows 25] [--shards 8] [--root DIR]

``--root`` imports the package of another checkout (the parent's, for
``scripts/torch_bitonic_ab.py``); it must have the same module layout.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-rows", type=int, default=25, help="rows per shard, log2")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="checkout whose rdst_tpu_torch runs")
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_shuffle_stages: CUDA is not available", file=sys.stderr)
        return 2
    from rdst_tpu_torch import _planes as P
    from rdst_tpu_torch import parallel as par
    from rdst_tpu_torch.ops import fused_merge as fm
    from rdst_tpu_torch.parallel import shuffle as sh

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

    acc: dict[str, float] = {}
    phase = ["local sorts"]

    def timed(fn, name_of):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            name = name_of()
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    merges: list[tuple[str, object, object]] = []

    def on_events(kind, fn):
        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            merges.append((kind, start, end))
            return out
        return wrapper

    real_sort, real_exchange = sh._local_sort, sh._exchange_raw
    real_b4, real_b5 = fm.merge_stage_call, fm.merge_tail_call
    timed_exchange = timed(real_exchange, lambda: "exchange")

    def exchange(*a, **k):
        out = timed_exchange(*a, **k)
        phase[0] = "finish sorts"
        return out

    sh._local_sort = timed(real_sort, lambda: phase[0])
    sh._exchange_raw = exchange
    fm.merge_stage_call = on_events("B4", real_b4)
    fm.merge_tail_call = on_events("B5", real_b5)
    try:
        for label, overlap in (("cold", False), ("warm", False),
                               ("overlapped", True)):
            acc.clear()
            merges.clear()
            phase[0] = "local sorts"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = par.distributed_sort([hi, lo], [pay], mesh=mesh, stable=True,
                                       overlap_exchange=overlap)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            del out
            rest = total - sum(acc.values())
            parts = "; ".join(f"{k} {v * 1e3:.2f} ms ({v / total:.1%})"
                              for k, v in acc.items())
            kern = "".join(
                f"; {kind} {len(t)} launches {sum(t):.2f} ms of device time"
                for kind in ("B4", "B5")
                for t in [[s.elapsed_time(e) for kd, s, e in merges if kd == kind]]
                if t)
            print(f"{label}: total {total * 1e3:.2f} ms; {parts}; the rest "
                  f"{rest * 1e3:.2f} ms ({rest / total:.1%}){kern}; peak "
                  f"{torch.cuda.max_memory_allocated()} B")
    finally:
        sh._local_sort, sh._exchange_raw = real_sort, real_exchange
        fm.merge_stage_call, fm.merge_tail_call = real_b4, real_b5

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = par.distributed_sort([hi, lo], [pay], mesh=mesh, stable=True)
    torch.cuda.synchronize()
    del out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = par.distributed_sort([hi, lo], [pay], mesh=mesh, stable=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    # kernels only: an operator's row repeats the device time of its kernels
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    print(f"profiled call: wall {wall:.2f} ms; device time summed over kernels "
          f"{busy:.2f} ms ({busy / wall:.3f} of the wall)")
    print(ka.table(sort_by="self_device_time_total", row_limit=14,
                   max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
