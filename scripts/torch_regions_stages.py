#!/usr/bin/env python3
"""Where the time of the port's low-memory Regions sort goes, on one CUDA card.

Sorts 2^30 int64 keys (39 bits of entropy, both signs) with int32 values,
stable, through the low-memory tuner above the 10 GiB gate (the call
``chip_smoke.py`` drives), the data made on the card from a seed.  The
first call and a warm one on the host clock (one synchronize at the end of
each), then one more warm call inside a profiler region, split by the
port's own spans (``scripts/torch_span_split.py``):

  rdst.fused_sort under rdst.plan.Regions   the chunk sorts (B8, or B2/B3);
  rdst.plan.Regions, own                    the merge tree (``merge_many``:
                                            each merge's bitonic sequence,
                                            its B4 and B5 launches, which
                                            have lines of their own) and
                                            the plan's other work;
  rdst.keys.*, rdst.sort, own               normalization, padding and the
                                            inverse transform.

    python3 scripts/torch_regions_stages.py [--root DIR] [--log2-n 30]

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
    ap.add_argument("--root", type=Path, default=ROOT,
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

    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sort()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    print(f"call: first {times[0]:.2f} ms, warm {times[1]:.2f} ms (host clock)")
    (ok, _), wall, trace = tss.record(sort, str(ROOT / "build" / "stage_traces"))
    if not bool((ok[1:] >= ok[:-1]).all()):
        raise AssertionError("the Regions sort's keys are not in order")
    del ok
    tss.report("Regions 2^%d" % args.log2_n, trace, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
