from rdst_tpu_torch.table.table import Table
from rdst_tpu_torch.table import ops

__all__ = ["Table", "ops"]
