"""Per-algorithm benchmark of the PyTorch port: ``scripts/bench_single_algo.py``
on ``rdst_tpu_torch`` (the reference's benches/single_algo_sort.rs).

One row per (Algorithm, key type) at 10M uniform keys, each forced through
the Sorter with a SingleAlgoTuner (single_algo_sort.rs:64-85's shape) and
timed on the device through ``torch_bench_suite``'s dispatcher step.
``--tuners`` adds BASELINE config 1's three-tuner ladder (default /
low-mem / single-threaded basic_sort, benches/basic_sort.rs:45-47).

A row is ``"mode": "chained"`` when its steps chain through the XOR rehash,
and ``"unchained"`` when its plan reads bucket values from the histogram
(the MtOop plan), so that every step sorts the same input
(``torch_bench_suite.reads_absolute_counts``).  Every row's last step is
checked bit for bit against ``torch.sort`` of its input before it prints.

    python scripts/torch_bench_single_algo.py [--types u32,u64] [--tuners]
    python scripts/torch_bench_single_algo.py --device cpu --n 4096 --iters 2
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from rdst_tpu_torch import keys as rkeys  # noqa: E402
from rdst_tpu_torch.sorter import Sorter  # noqa: E402
from rdst_tpu_torch.tuner import (  # noqa: E402
    Algorithm,
    LowMemoryTuner,
    SingleAlgoTuner,
    SingleThreadedTuner,
    StandardTuner,
)
from scripts.torch_bench_suite import bench_config, emit  # noqa: E402

N = 10_000_000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--types", default="u32,u64")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--tuners", action="store_true",
                    help="also run config 1's default/low-mem/"
                         "single-threaded tuner rows (u32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed steps (default: bench_suite.py's rule)")
    args = ap.parse_args()
    dev = rkeys.as_device(args.device)

    rng = np.random.default_rng(0)
    gens = {
        "u32": lambda: rng.integers(0, 2**32, args.n, dtype=np.int64)
        .astype(np.uint32),
        "u64": lambda: rng.integers(0, 2**64, args.n, dtype=np.uint64),
    }

    def bench(metric, x, tuner):
        nk = rkeys.normalize(x, device=dev)
        t, _, mode = bench_config(metric, list(nk.words), [], nk.n_bytes, False,
                                  Sorter(tuner=tuner), iters=args.iters)
        emit(metric, args.n, t, extra={"mode": mode})

    for tname in args.types.split(","):
        x = gens[tname]()
        for algo in Algorithm:
            bench(
                f"single_algo_{algo.name.lower()}_{tname}_{args.n}",
                x, SingleAlgoTuner(algo),
            )

    if args.tuners:
        x = gens["u32"]()
        for label, tuner in (
            ("default", StandardTuner()),
            ("low_mem", LowMemoryTuner()),
            ("single_threaded", SingleThreadedTuner()),
        ):
            bench(f"basic_sort_u32_{args.n}_{label}", x, tuner)


if __name__ == "__main__":
    main()
