#!/usr/bin/env python3
"""Where the time of the port's low-memory Regions sort goes, on one CUDA card.

Sorts 2^30 int64 keys (39 bits of entropy, both signs) with int32 values,
stable, through the low-memory tuner above the 10 GiB gate (the call
``chip_smoke.py`` drives), the data made on the card from a seed.  After a
warm-up call it prints, for one call:

  chunk sorts   each chunk sort (``regions.comparative_sort``: B2/B3), host
                clock with a synchronize around it;
  merges        each ``merge_sorted`` of the merge tree, host clock with a
                synchronize around it, and its B4 (stride) and B5 (tail)
                launches with their device time, from CUDA events recorded
                around each launch;
  copies        a merge's time less its B4 and B5 time: the bitonic
                sequence's cat and flip copies and the tiebreak plane;
  the rest      the call less the chunk sorts and the merges: key
                normalization, padding, the inverse transform;

then one more call under ``torch.profiler``: its kernels by device time.

    python3 scripts/torch_regions_stages.py [--root DIR] [--log2-n 30]

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
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="checkout whose rdst_tpu_torch runs")
    ap.add_argument("--log2-n", type=int, default=30)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_regions_stages: CUDA is not available", file=sys.stderr)
        return 2
    import rdst_tpu_torch as rt
    from rdst_tpu_torch.ops import fused_merge as fm
    from rdst_tpu_torch.ops import merge as tmerge
    from rdst_tpu_torch.sorts import regions

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n = 1 << args.log2_n
    keys = torch.empty(n, dtype=torch.int64, device=dev).random_(generator=gen)
    keys >>= 24
    keys ^= keys << 63
    vals = torch.empty(n, dtype=torch.int32, device=dev).random_(generator=gen)
    print(f"device: {torch.cuda.get_device_name(0)}; package {rt.__file__}; "
          f"{n} int64 keys + int32 values, stable, low-memory tuner")

    def sort():
        return rt.radix_sort_builder(keys, [vals]).with_low_mem_tuner() \
            .with_stable().sort()

    out = sort()
    torch.cuda.synchronize()
    del out

    launches: list[tuple[str, object, object]] = []
    stages: list[tuple[str, float, list[float], list[float]]] = []

    def on_events(kind, fn):
        def wrapper(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(*a, **k)
            end.record()
            launches.append((kind, start, end))
            return res
        return wrapper

    def timed(label_of, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            launches.clear()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            dev_ms = {kind: [s.elapsed_time(e) for kd, s, e in launches if kd == kind]
                      for kind in ("B4", "B5")}
            stages.append((label_of(*a), ms, dev_ms["B4"], dev_ms["B5"]))
            return res
        return wrapper

    saved = (regions.comparative_sort, tmerge.merge_sorted, fm.merge_stage_call,
             fm.merge_tail_call)
    regions.comparative_sort = timed(
        lambda w, *_: f"chunk sort of {int(w[0].shape[0])} rows", saved[0])
    tmerge.merge_sorted = timed(
        lambda a, b, *_: f"merge of {int(a[0].shape[0])} + {int(b[0].shape[0])} rows",
        saved[1])
    fm.merge_stage_call = on_events("B4", saved[2])
    fm.merge_tail_call = on_events("B5", saved[3])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (ok, _) = sort()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        (regions.comparative_sort, tmerge.merge_sorted, fm.merge_stage_call,
         fm.merge_tail_call) = saved
    if not bool((ok[1:] >= ok[:-1]).all()):
        raise AssertionError("the Regions sort's keys are not in order")
    del ok

    print(f"call: {total:.2f} ms (host clock, synchronized stages)")
    chunks = merges = 0.0
    for label, ms, b4, b5 in stages:
        if label.startswith("chunk"):
            chunks += ms
            print(f"  {label}: {ms:.2f} ms")
            continue
        merges += ms
        copies = ms - sum(b4) - sum(b5)
        print(f"  {label}: {ms:.2f} ms; B4 {len(b4)} launches {sum(b4):.2f} ms "
              f"(each {min(b4, default=0):.3f}-{max(b4, default=0):.3f}); B5 "
              f"{len(b5)} launches {sum(b5):.2f} ms; copies and the rest of the "
              f"merge {copies:.2f} ms")
    b4_all = sum(sum(b4) for _, _, b4, _ in stages)
    b5_all = sum(sum(b5) for _, _, _, b5 in stages)
    rest = total - chunks - merges
    print(f"split: chunk sorts {chunks:.2f} ms ({chunks / total:.1%}); merges "
          f"{merges:.2f} ms ({merges / total:.1%}) of which B4 {b4_all:.2f} ms "
          f"({b4_all / total:.1%}), B5 {b5_all:.2f} ms ({b5_all / total:.1%}), "
          f"copies {merges - b4_all - b5_all:.2f} ms "
          f"({(merges - b4_all - b5_all) / total:.1%}); the rest {rest:.2f} ms "
          f"({rest / total:.1%})")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = sort()
        torch.cuda.synchronize()
    del out
    ka = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3
    print(f"profiled call: device time summed over kernels {busy:.2f} ms")
    print(ka.table(sort_by="self_device_time_total", row_limit=12,
                   max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
