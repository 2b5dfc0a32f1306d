"""How many of a call's kernels a profiler trace keeps as the process ages.

On the machine with the card, a process whose CUDA context had run for a
minute or two was seen to drop the first kernels of a ``profile_to`` trace.
This script measures it: one ``Sorter.run`` of 2^25 u64 keys on the card,
traced when the context is new, again after ``--seconds`` of sorting, once
more with the profiler started in a warm-up step, once with a pause between
the profiler's start and the call, and then in a fresh process.  Each line
gives the kernel events in the trace, the ``hist_kernel`` (B1) events among
them and the kernel launches the trace recorded on the host.

    python3 scripts/torch_trace_age.py [--seconds 150]
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
T0 = time.time()


def trace(tag, sorter, nk, torch, warm_up=False, pause=0.0):
    from rdst_tpu_torch.utils.trace import profile_to

    logdir = os.path.join(ROOT, "build", "torch_trace_age")
    P = torch.profiler.ProfilerActivity
    if warm_up:
        path = os.path.join(logdir, f"warm_up.{time.time_ns()}.json")
        os.makedirs(logdir, exist_ok=True)
        with torch.profiler.profile(
                activities=[P.CPU, P.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            torch.cuda.synchronize()
            prof.step()
            sorter.run(nk)
            torch.cuda.synchronize()
    else:
        with profile_to(logdir) as path:
            time.sleep(pause)
            sorter.run(nk)
    events = json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "")]
    print(f"[process {time.time() - T0:.0f} s] {tag}: {len(kernels)} kernel events, "
          f"{sum('hist_kernel' in e['name'] for e in kernels)} hist_kernel, "
          f"{len(launches)} launches recorded", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import numpy as np
    import torch

    import rdst_tpu_torch as rt
    from rdst_tpu_torch import _build, keys
    from rdst_tpu_torch.sorter import Sorter

    if not torch.cuda.is_available():
        sys.exit("torch_trace_age: needs a CUDA card")
    _build.library()
    dev = torch.device("cuda", 0)
    x = torch.empty(1 << 25, dtype=torch.int64, device=dev).random_()
    nk = keys.normalize(x.view(torch.uint64), device=dev)
    sorter = Sorter()
    sorter.run(nk)
    torch.cuda.synchronize()
    if args.child:
        trace("a fresh process", sorter, nk, torch)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    trace("new context", sorter, nk, torch)
    rng = np.random.default_rng(0)
    t_work = time.time()
    while time.time() - t_work < args.seconds:
        for _ in range(20):
            rt.radix_sort_unstable(rng.integers(0, 2**64, 1 << 16, dtype=np.uint64))
        sorter.run(nk)
        torch.cuda.synchronize()
    trace(f"after {args.seconds:.0f} s of sorts", sorter, nk, torch)
    trace("the same, profiler started in a warm-up step", sorter, nk, torch,
          warm_up=True)
    trace("the same, 0.1 s between the profiler's start and the call", sorter, nk,
          torch, pause=0.1)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--child"], check=True)


if __name__ == "__main__":
    main()
