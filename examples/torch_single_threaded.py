"""Single-program mode on the PyTorch port (reference:
examples/single_threaded.rs).

    python examples/torch_single_threaded.py [--device cuda|cpu]
"""
import argparse

import numpy as np

import rdst_tpu_torch as rt

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

x = np.random.default_rng(0).standard_normal(50_000).astype(np.float32)
sorted_x = (
    rt.radix_sort_builder(x, device=args.device)
    .with_parallel(False)
    .with_single_threaded_tuner()
    .sort()
)
assert np.array_equal(sorted_x, np.sort(x))
print("single-program sort ok")
