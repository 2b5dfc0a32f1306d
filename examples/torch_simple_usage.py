"""Basic sorting on the PyTorch port (reference: examples/simple_usage.rs).

    python examples/torch_simple_usage.py [--device cuda|cpu]
"""
import argparse

import numpy as np

import rdst_tpu_torch as rt

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

x = np.random.default_rng(0).integers(0, 2**32, size=100_000, dtype=np.uint32)
sorted_x = rt.radix_sort_unstable(x, device=args.device)
print("sorted:", sorted_x[:5], "...", sorted_x[-5:])
assert np.array_equal(sorted_x, np.sort(x))
