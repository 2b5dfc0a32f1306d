"""Sort execution plans of the port (``rdst_tpu/sorts/``); the registry
mapping Algorithm names onto them is in ``rdst_tpu_torch/sorter.py``."""
from rdst_tpu_torch.sorts.comparative import comparative_sort
from rdst_tpu_torch.sorts.lsb import packed_sort
from rdst_tpu_torch.sorts.msb import bucketed_sort
from rdst_tpu_torch.sorts.regions import chunked_sort

__all__ = [
    "comparative_sort",
    "packed_sort",
    "bucketed_sort",
    "chunked_sort",
]
