from rdst_tpu_torch.table.table import Table
from rdst_tpu_torch.table import ops
from rdst_tpu_torch.table import tpch

__all__ = ["Table", "ops", "tpch"]
