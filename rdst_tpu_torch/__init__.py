"""rdst_tpu_torch — the sort engine of ``rdst_tpu`` on PyTorch and CUDA.

The port of the JAX package's single-chip sort path: key normalization, the
histogram-driven Sorter with its tuners, and the fused bitonic executor,
with hand-written CUDA kernels for Hopper (sm_90a) in ``csrc/``.  The
public surface mirrors ``rdst_tpu``'s with torch tensors in place of jax
arrays:

    import rdst_tpu_torch as rt
    y = rt.radix_sort_unstable(x)                    # numpy x -> on "cuda"
    y = rt.radix_sort_unstable(x, device="cpu")      # plain versions, host
    y = rt.radix_sort_builder(t).with_low_mem_tuner().sort()  # tensor t
    k, v = rt.sort_key_value(keys, vals, stable=True)
    idx = rt.argsort(x)

A tensor sorts on its own device; numpy input goes to ``device`` (default
``"cuda"``, which raises when CUDA is absent).  This package never imports
JAX.
"""
from rdst_tpu_torch import keys
from rdst_tpu_torch.tuner import (
    Algorithm,
    TuningParams,
    Tuner,
    StandardTuner,
    LowMemoryTuner,
    SingleThreadedTuner,
)
from rdst_tpu_torch.builder import (
    RadixSortBuilder,
    radix_sort_unstable,
    radix_sort_builder,
    sort_key_value,
    argsort,
)

__version__ = "0.1.0"

__all__ = [
    "keys",
    "Algorithm",
    "TuningParams",
    "Tuner",
    "StandardTuner",
    "LowMemoryTuner",
    "SingleThreadedTuner",
    "RadixSortBuilder",
    "radix_sort_unstable",
    "radix_sort_builder",
    "sort_key_value",
    "argsort",
]
