"""Bytes Q18 needs: each column it references (LINEITEM's l_orderkey and
l_quantity, ORDERS' four, CUSTOMER's two) read once and its answer written
once, the formula of ``sort.py``."""
from pathlib import Path

import bench_core

necessary_bytes = bench_core.module("bytes", "sort",
                                    Path(__file__).resolve().parent.parent).necessary_bytes
