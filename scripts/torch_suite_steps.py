"""Where a bench_suite step's time goes on the card.

One chained step of ``scripts/torch_bench_suite.py``'s c1 (10M u32) and of
its c2 stable (10M u64 + u32 payload), three times each, under
``torch.profiler``: the step's CUDA-event time, the host's time to enqueue
it, and the kernels' device time by name, so the card's busy share of the
step; then the same for the floor table's fused raw step on the same
planes (``torch_floor_table.fused_step``: the fused executor alone, no
dispatcher).  Then ``engine.sort_words`` of uniform u32 keys at 2^20..2^23 (the
timings harness's call): CUDA-event time, enqueue time and the port's
kernel launches.  Needs a card.

    python scripts/torch_suite_steps.py
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rdst_tpu_torch import _build  # noqa: E402
from rdst_tpu_torch import _planes as P  # noqa: E402
from rdst_tpu_torch import keys as rkeys  # noqa: E402
from rdst_tpu_torch.engine import sort_words  # noqa: E402
from rdst_tpu_torch.ops.histogram import multi_level_histogram  # noqa: E402
from rdst_tpu_torch.sorter import Sorter  # noqa: E402
from scripts.torch_bench_suite import dispatcher_step, make_configs  # noqa: E402
from scripts.torch_floor_table import fused_step  # noqa: E402


def timed(fn):
    """(CUDA-event ms, host enqueue ms, profiler) of one call of ``fn``."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        ev[0].record()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        ev[1].record()
        torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), (t1 - t0) * 1e3, prof


def kernels(prof):
    """(total device ms, the five longest kernels as text)."""
    ka = [k for k in prof.key_averages() if k.device_time_total > 0
          and k.device_type.name == "CUDA"]
    top = sorted(ka, key=lambda k: -k.device_time_total)[:5]
    return (sum(k.device_time_total for k in ka) / 1e3,
            "; ".join(f"{k.key[:36]} {k.device_time_total / 1e3:.4f} ms x{k.count}"
                      for k in top))


def chained(label, step, args):
    """Three chained calls of ``step`` after three warm ones, each timed
    and profiled alone."""
    state = [args]
    for _ in range(3):  # warm
        state[0] = step(state[0])

    def one():
        state[0] = step(state[0])

    for rep in range(3):
        wall, enqueue, prof = timed(one)
        busy, top = kernels(prof)
        print(f"{label} step {rep}: {wall:.4f} ms (CUDA events, under the "
              f"profiler), enqueue {enqueue:.4f} ms, kernels {busy:.4f} ms "
              f"({busy / wall:.1%} busy); {top}", flush=True)


def main():
    dev = rkeys.as_device("cuda")
    configs = make_configs(np.random.default_rng(0), 10_000_000, {"1", "2"})
    for metric, words, pays, n_bytes, stable, scramble in (configs[0], configs[2]):
        ws = [torch.from_numpy(w).to(dev) for w in words]
        ps = [torch.from_numpy(p).to(dev) for p in pays]
        hist = multi_level_histogram(ws, n_bytes)
        step = dispatcher_step(len(ws), n_bytes, stable, hist, Sorter(), scramble)
        chained(metric, step, tuple(ws) + tuple(ps))
        chained(f"{metric} fused raw", fused_step(len(ws), stable), tuple(ws) + tuple(ps))
    for e in range(20, 24):
        x = [P.narrow(torch.randint(0, 1 << 32, (1 << e,), device=dev, dtype=torch.int64),
                      torch.uint32)]
        for _ in range(2):
            sort_words(x)
        for k in _build.KERNELS.values():
            k.launches = 0
        wall, enqueue, prof = timed(lambda: sort_words(x))
        busy, top = kernels(prof)
        launches = {k: v.launches for k, v in _build.KERNELS.items() if v.launches}
        print(f"sort_words u32 2^{e}: {wall:.4f} ms (CUDA events, under the profiler), "
              f"enqueue {enqueue:.4f} ms, kernels {busy:.4f} ms; launches {launches}; "
              f"{top}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
