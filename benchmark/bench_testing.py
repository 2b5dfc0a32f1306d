"""Helpers of the benchmark's own tests: a cell's files at a size that a
CPU test run holds, and one run of it on CPU entries."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

import bench_core as core  # noqa: E402

# The tests' sizes are small: one thread a process keeps several test
# processes from starving each other of cores.
torch.set_num_threads(1)


def small(cell: str, root: Path = HERE, n_keys: int = 1 << 14):
    """(cell file, configuration, traffic) of ``cell`` cut to a CPU test's
    size, two answers of each operation judged besides its last."""
    c = core.cell_file(cell, root)
    config = copy.deepcopy(core.config_file(c["config"], root))
    traffic = copy.deepcopy(core.traffic_file(c["traffic"], root))
    config["n_keys"] = n_keys
    traffic["keep"] = 2
    traffic["warm_calls"] = 1
    return c, config, traffic


def run_small(cell: str, *, seed: int = 2**31 + 7, seconds: float = 0.5, trace=False,
              program="port", root: Path = HERE, **sizes) -> dict:
    """One run of ``cell`` on CPU entries (one per card it asks for) at a
    small size; adds ``correct`` as the command decides it."""
    c, config, traffic = small(cell, root, **sizes)
    res = core.run_cell(cell, config, traffic, seed=seed, seconds=seconds, trace=trace,
                        devices=["cpu"] * c["chips"], t_process=time.monotonic(),
                        program=program, root=root, log=lambda *a: None)
    res["correct"] = core.correct(res)
    return res
