"""Bytes Q1 needs: each LINEITEM column it references (l_quantity,
l_extendedprice, l_discount, l_tax, l_returnflag, l_linestatus,
l_shipdate) read once and its answer written once, the formula of
``sort.py``."""
from pathlib import Path

import bench_core

necessary_bytes = bench_core.module("bytes", "sort",
                                    Path(__file__).resolve().parent.parent).necessary_bytes
