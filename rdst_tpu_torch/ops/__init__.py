"""Device operations of the port (``rdst_tpu/ops/``): the kernel wrappers
and their plain PyTorch versions."""
from rdst_tpu_torch.ops.histogram import (
    multi_level_histogram,
    level_histogram,
    HistogramResult,
)
from rdst_tpu_torch.ops.prefix import exclusive_prefix_sum, end_offsets
from rdst_tpu_torch.ops.rows import batched_sort, batched_top_k

__all__ = [
    "batched_sort",
    "batched_top_k",
    "multi_level_histogram",
    "level_histogram",
    "HistogramResult",
    "exclusive_prefix_sum",
    "end_offsets",
]
