"""rdst_tpu_torch — the sort engine of ``rdst_tpu`` on PyTorch and CUDA.

The port of the JAX package: key normalization, the histogram-driven
Sorter with its tuners, the fused bitonic executor, the row-batched sorts,
the static-plan ``jit_api``, the columnar table engine and (in
``rdst_tpu_torch.parallel``) the distributed shuffle and table pipeline,
with hand-written CUDA kernels for Hopper (sm_90a) in ``csrc/``.  The
public surface mirrors ``rdst_tpu``'s with torch tensors in place of jax
arrays:

    import rdst_tpu_torch as rt
    y = rt.radix_sort_unstable(x)                    # numpy x -> on "cuda"
    y = rt.radix_sort_unstable(x, device="cpu")      # plain versions, host
    y = rt.radix_sort_builder(t).with_low_mem_tuner().sort()  # tensor t
    k, v = rt.sort_key_value(keys, vals, stable=True)
    idx = rt.argsort(x)
    ks, (vs,) = rt.jit_api.sort(t, payloads=[v])     # no host sync
    rows, _ = rt.batched_sort(x2d)                   # every row
    top, _ = rt.batched_top_k(x2d, 64)
    t = rt.Table({"k": keys, "v": vals})             # numpy -> on "cuda"
    out, n_groups = t.group_aggregate("k", {"s": ("v", "sum")})

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
from rdst_tpu_torch.ops.rows import batched_sort, batched_top_k
from rdst_tpu_torch import jit_api
from rdst_tpu_torch.table import Table

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
    "batched_sort",
    "batched_top_k",
    "jit_api",
    "Table",
]
