"""Rows completed per second by calls whose keys are in host memory (numpy
in, numpy out), read as ``rows_per_s`` reads it: every key of every call
completed in the window over the window's whole time, host clock.  A
metric of its own only for its bound: the host path spreads far wider
from run to run than the card's."""
from pathlib import Path

import bench_core

read = bench_core.module("metrics", "rows_per_s", Path(__file__).resolve().parent.parent).read
