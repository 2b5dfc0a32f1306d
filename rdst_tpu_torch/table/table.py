"""Columnar Table: named columns over tensors.

Port of ``rdst_tpu/table/table.py``.  The generalization target of the sort
engine: sort-based hash aggregate, filter and joins over columnar tables,
all reusing the sort primitives.  Any subset of columns forms a composite
key.

Numpy columns go to ``device`` (default ``"cuda"``, which raises when CUDA
is absent); a tensor column stays on its own device, and every column of a
table must lie on one device.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

from rdst_tpu_torch.keys import _to_tensor

__all__ = ["Table"]


class Table:
    """Immutable columnar table.  Columns are 1-D tensors of equal length
    on one device."""

    def __init__(self, columns: Mapping[str, torch.Tensor], *, device="cuda"):
        cols = {name: _to_tensor(c, device) for name, c in dict(columns).items()}
        if not cols:
            raise ValueError("table needs at least one column")
        n = dev = None
        for name, c in cols.items():
            if c.ndim != 1:
                raise ValueError(f"column {name!r} must be 1-D")
            if n is None:
                n, dev = int(c.shape[0]), c.device
            elif int(c.shape[0]) != n:
                raise ValueError("column length mismatch")
            elif c.device != dev:
                raise ValueError(
                    f"column {name!r} is on {c.device}, the table on {dev}")
        self._columns = cols
        self._n = n

    # -- basic accessors ---------------------------------------------------

    @property
    def column_names(self) -> list[str]:
        return list(self._columns)

    @property
    def n_rows(self) -> int:
        return self._n

    @property
    def device(self) -> torch.device:
        return next(iter(self._columns.values())).device

    def column(self, name: str) -> torch.Tensor:
        return self._columns[name]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._columns[name]

    def with_column(self, name: str, values) -> "Table":
        cols = dict(self._columns)
        cols[name] = values
        return Table(cols, device=self.device)

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self._columns[n] for n in names})

    def head(self, k: int = 10) -> dict:
        return {n: c[:k].cpu().numpy() for n, c in self._columns.items()}

    def to_numpy(self) -> dict:
        return {n: c.cpu().numpy() for n, c in self._columns.items()}

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}:{str(c.dtype).removeprefix('torch.')}"
            for n, c in self._columns.items()
        )
        return f"Table[{self._n} rows; {cols}]"

    # -- relational ops (implemented in rdst_tpu_torch.table.ops) ----------

    def sort_by(self, by, **kw) -> "Table":
        from rdst_tpu_torch.table import ops

        return ops.sort_by(self, by, **kw)

    def filter(self, mask, **kw):
        from rdst_tpu_torch.table import ops

        return ops.filter(self, mask, **kw)

    def group_aggregate(self, by, aggs, **kw):
        from rdst_tpu_torch.table import ops

        return ops.group_aggregate(self, by, aggs, **kw)

    def join(self, other: "Table", on, **kw):
        from rdst_tpu_torch.table import ops

        return ops.join(self, other, on, **kw)
