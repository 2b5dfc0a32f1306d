"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``rdst_tpu_torch`` and
``BENCHMARK.json``.  The cell (``benchmark/workloads/<cell>.json``) names
its configuration, its traffic and the cards it needs.  The run makes its
inputs from ``--seed``, warms up, measures for ``--seconds`` in a closed
loop, judges a sample of the answers against the plain reference, and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error).  Earlier lines carry the tuner's
picks, the kernel launch counters, the sample counts and per-card numbers.

A run needs CUDA and as many cards as the cell asks for; without them it
exits with code 2 and prints no result.  It exits with code 3, and prints
no result, if JAX or the JAX package is loaded once the window has closed.
The kernels build into ``build/`` of the checkout on its first run there;
Triton's and torch's extension caches are fixed folders beside them.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def _caches():
    build = ROOT / "build" / "benchmark"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def _power_limits(n: int) -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ["not read"] * n
    return [line.split(",")[-1].strip() for line in out.splitlines() if line.strip()][:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path.insert(0, str(ROOT))
    import bench_core as core

    manifest = core.load_json(ROOT / "BENCHMARK.json")
    cell = core.cell_file(args.workload)
    config = core.config_file(cell["config"])
    traffic = core.traffic_file(cell["traffic"])
    section = "per_layer" if args.trace else "end_to_end"
    metrics = core.reported(manifest, args.workload, section)

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(chips)]
    res = core.run_cell(args.workload, config, traffic, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace), devices=devices,
                        t_process=T_PROCESS)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {loaded}", file=sys.stderr)
        return 3

    run = res["run"]
    names = [torch.cuda.get_device_name(i) for i in range(chips)]
    power = _power_limits(chips)
    calls = sum(1 for s in run.spans if s.ok)
    print(f"bench: {calls} completed calls in the window of {run.window_s:.4f} s "
          f"(the sample behind call_p95_ms); {res['answers']} answers judged; "
          f"{res['errors']} calls raised")
    for op in sorted({s.op for s in run.spans}):
        ms = sorted((s.end - s.start) * 1e3 for s in run.spans if s.ok and s.op == op)
        if ms:
            q = [round(core.percentile(ms, x), 3) for x in (0, 10, 50, 90, 100)]
            print(f"bench: {op}: {len(ms)} calls, ms at 0/10/50/90/100%: {q}")
    print(f"bench: cards {names}, power limits {power}, peak bytes per card {run.peaks}")
    device = {"platform": "gpu", "kind": names[0], "count": chips,
              "memory_peak_bytes": max(run.peaks), "power_limit": power}
    out = {"correct": core.correct(res), "attempted": len(run.spans),
           "failed": res["errors"] + res["wrong_answers"],
           "metrics": core.metric_values(run, metrics), "device": device}
    if args.trace:
        p = run.profile
        device["busy_s"] = p.mean_busy_ns() / 1e9
        device["window_s"] = p.window_ns / 1e9
        per_card = {d: round(100 * (1 - p.busy_ns(d) / p.window_ns), 4) for d in p.devices()}
        print(f"bench: traced stretch of {p.calls()} calls, {p.window_ns / 1e9:.6f} s; "
              f"idle % per card {per_card}")
        out["breakdown"] = {"device_ops": p.top_device_ops(), "idle_gaps": p.top_idle()}
    if res["unjudged"]:
        print(f"bench: no answer judged for {res['unjudged']}")
    out["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
