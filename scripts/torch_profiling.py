"""Profiler entry point of the PyTorch port: ``scripts/profiling.py`` on
``rdst_tpu_torch`` (the reference's scripts/profiling.rs).

profiling.rs (reference: scripts/profiling.rs:87-109) builds a
profiler-friendly binary whose sleep markers separate input generation
from the sort, so that a sampling profiler can window the region of
interest.  This script keeps the same generate / sleep / sort / sleep
phases and records the sort with ``utils.trace.profile_to``: one
Chrome-trace JSON file of the whole pipeline (histogram, tuner, plan
kernels), host activity and, on a card, its kernels.

    python scripts/torch_profiling.py --n 10000000 --trace build/torch_trace
    python scripts/torch_profiling.py --device cpu --n 100000

Each level's algorithm pick prints during the warm-up (the work_profiles
trace, sorter.rs:78-79), so the kernels in the trace can be attributed to
plans.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--dtype", default="uint64")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=os.path.join(ROOT, "build", "torch_trace"),
                    help="directory the Chrome-trace JSON file is written to")
    ap.add_argument("--sleep", type=float, default=0.5,
                    help="marker sleeps separating phases (profiling.rs)")
    args = ap.parse_args()

    import rdst_tpu_torch as rt
    from rdst_tpu_torch import config
    from rdst_tpu_torch.utils.trace import profile_to

    rng = np.random.default_rng(0)
    info = np.iinfo(args.dtype)
    x = rng.integers(info.min, info.max, size=args.n, endpoint=True,
                     dtype=args.dtype)

    # warm (kernel build and first calls outside the trace, so the trace
    # shows the steady state)
    with config.work_profiles(True):
        warm = rt.radix_sort_unstable(x, device=args.device)
    del warm

    time.sleep(args.sleep)  # marker: input and warm-up done
    with profile_to(args.trace) as path:
        out = rt.radix_sort_unstable(x, device=args.device)
    time.sleep(args.sleep)  # marker: sort done

    assert np.array_equal(np.sort(x), out)
    print(f"trace written to {path}; sorted {args.n} ok")


if __name__ == "__main__":
    main()
