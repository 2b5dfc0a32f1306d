"""Plugging a custom tuner into the PyTorch port (reference:
examples/custom_tuner.rs).

    python examples/torch_custom_tuner.py [--device cuda|cpu]
"""
import argparse

import numpy as np

import rdst_tpu_torch as rt


class MyTuner:
    """Prefer the low-memory chunked plan for big inputs."""

    def pick_algorithm(self, p: rt.TuningParams, counts):
        if p.input_len <= 128:
            return rt.Algorithm.COMPARATIVE
        if p.input_len >= 500_000:
            return rt.Algorithm.REGIONS
        return rt.Algorithm.LSB


ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

x = np.random.default_rng(0).integers(0, 2**64, size=600_000, dtype=np.uint64)
sorted_x = rt.radix_sort_builder(x, device=args.device).with_tuner(MyTuner()).sort()
assert np.array_equal(sorted_x, np.sort(x))
print("custom tuner sort ok")
