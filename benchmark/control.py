"""Run a cell's control: the kind's plain reference, at the next lower
precision, in the port's place, judged by the same comparison.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

Each seed is one run of the cell at its own size (set-up, a short window
at the cell's load, the check) in this one process.  It prints every
compared number beside its limit for each seed, and exits with code 0
only when every seed's control came out not correct: each limit then lies
below the control's reading.  The benchmark's own runs never run it.
"""
import argparse
import sys
import time
from pathlib import Path



def controls(cell: str, seeds, seconds: float, devices=None, config=None, traffic=None,
             log=print) -> list[dict]:
    """Each seed's checks under the control, as ``run_cell`` returns them."""
    import bench_core as core

    c = core.cell_file(cell)
    config = config or core.config_file(c["config"])
    traffic = traffic or core.traffic_file(c["traffic"])
    devices = devices or [f"cuda:{i}" for i in range(c["chips"])]
    out = []
    for seed in seeds:
        res = core.run_cell(cell, config, traffic, seed=seed, seconds=seconds, trace=False,
                            devices=devices, t_process=time.monotonic(), program="control",
                            log=log)
        res["correct"] = core.correct(res)
        out.append(res)
        log(f"control {cell} seed {seed}: correct {res['correct']}; " + "; ".join(
            f"{k} {v['value']} (limit {v['limit']})" for k, v in res["checks"].items()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    res = controls(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds)
    return 0 if not any(r["correct"] for r in res) else 1


if __name__ == "__main__":
    sys.exit(main())
