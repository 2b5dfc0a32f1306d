"""TPC-H Q1 and Q18 as plans of the distributed table operators.

TPC Benchmark H, Standard Specification revision 3.0.1: Q1, the Pricing
Summary Report (§2.4.1), and Q18, the Large Volume Customer query
(§2.4.18), over tables whose columns are tensors on the mesh's cards::

    from rdst_tpu_torch.parallel import make_mesh
    from rdst_tpu_torch.table import tpch
    mesh = make_mesh(8)
    report = tpch.q1(lineitem, delta_days=90, mesh=mesh)        # 4 rows
    top = tpch.q18(lineitem, orders, customer, quantity=300, mesh=mesh)

Columns, by the specification's names: LINEITEM ``l_orderkey``,
``l_quantity``, ``l_extendedprice``, ``l_discount``, ``l_tax``,
``l_returnflag``, ``l_linestatus``, ``l_shipdate``; ORDERS ``o_orderkey``,
``o_custkey``, ``o_orderdate``, ``o_totalprice``; CUSTOMER ``c_custkey``,
``c_name``.  Decimals are int64 fixed point: quantity, discount and tax in
hundredths, prices in cents; keys int64; flags uint8 (ASCII); dates int32
days since 1970-01-01; ``c_name`` any dtype (a dictionary code), returned
as it is.  Tables may have any length.

Every sum and count is exact: Q1's ``disc_price`` (price x (1 - discount))
is in 10^-4 dollars and its ``charge`` (x (1 + tax)) in 10^-6 dollars,
summed in int64 (exact while a group's sum stays below 2^63).  Averages
are ``float64(sum) / float64(count)`` of those sums, in the column's own
units; the operators' float32 ``mean`` is not used.  Each query is the
span ``rdst.query.q1`` or ``rdst.query.q18``.

The plans partition by range: the tables come in orderkey (and custkey)
order, as dbgen writes them, so each shard's rows already form one key
range and the exchanges move few rows; a hash word would add a plane to
every shuffled row.  Q1's four groups take range too: each single-key
bucket is split over the shards by rank, so every shard gets its share.
The joins give their left side (ORDERS, CUSTOMER) a capacity of 1.1 times
a shard's rows, not the operators' 1.5: the keys are dense in their range
and the join's buckets whole, so a shard receives its share and at most
one bucket more (at SF 100, 1,024 orders or 256 customers).  The smaller
receive buffers take a third less memory and sorting, and CUSTOMER's
shards, 2.06M rows at SF 100, then stay under the fused executor's
threshold (``config.fused_min_elems``, 2^21): at 2.8M rows its piece
merges left the card idle about 270 ms of each Q18.
"""
from __future__ import annotations

import datetime

import torch

from rdst_tpu_torch.parallel import dtable as _dt
from rdst_tpu_torch.table import ops as _ops
from rdst_tpu_torch.table.table import Table
from rdst_tpu_torch.utils.trace import traced

__all__ = ["q1", "q18", "Q1_COLUMNS", "Q18_COLUMNS", "q1_cutoff"]

#: Q1's answer, in the specification's order.
Q1_COLUMNS = ("l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
              "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc",
              "count_order")
#: Q18's answer; ``sum_qty`` is the specification's ``sum(l_quantity)``.
Q18_COLUMNS = ("c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice",
               "sum_qty")
_Q1_BASE = (datetime.date(1998, 12, 1) - datetime.date(1970, 1, 1)).days
_Q18_LIMIT = 100
_JOIN_CAPACITY = 1.1


def q1_cutoff(delta_days: int) -> int:
    """Q1's last ship date, ``date '1998-12-01' - interval DELTA day``, in
    days since 1970-01-01."""
    return _Q1_BASE - int(delta_days)


@traced("query.q1")
def q1(lineitem: Table, *, delta_days: int, mesh) -> Table:
    """Q1: the lines shipped by the cutoff (a filter on every shard),
    grouped by (l_returnflag, l_linestatus) with its eight aggregates, in
    that order.  Returns a Table of at most 4 rows on the mesh's device."""
    li = lineitem
    disc_price = li["l_extendedprice"] * (100 - li["l_discount"])
    charge = disc_price * (100 + li["l_tax"])
    rows = Table({
        "l_returnflag": li["l_returnflag"], "l_linestatus": li["l_linestatus"],
        "l_quantity": li["l_quantity"], "l_extendedprice": li["l_extendedprice"],
        "disc_price": disc_price, "charge": charge, "l_discount": li["l_discount"],
    })
    del disc_price, charge
    kept, counts = _dt.distributed_filter(
        rows, li["l_shipdate"] <= q1_cutoff(delta_days), mesh=mesh)
    del rows
    aggs = {"sum_qty": ("l_quantity", "sum"), "sum_base_price": ("l_extendedprice", "sum"),
            "sum_disc_price": ("disc_price", "sum"), "sum_charge": ("charge", "sum"),
            "sum_disc": ("l_discount", "sum"), "count_order": (None, "count")}
    groups, _ = _dt.distributed_group_aggregate(
        kept, ["l_returnflag", "l_linestatus"], aggs, mesh=mesh, counts=counts)
    del kept
    n = groups["count_order"].to(torch.int64)
    cols = {c: groups[c] for c in Q1_COLUMNS[:6]}
    cols.update(avg_qty=_mean(groups["sum_qty"], n),
                avg_price=_mean(groups["sum_base_price"], n),
                avg_disc=_mean(groups["sum_disc"], n), count_order=n)
    return _ops.sort_by(Table(cols), ["l_returnflag", "l_linestatus"])


def _mean(total: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return total.to(torch.float64) / n.to(torch.float64)


@traced("query.q18")
def q18(lineitem: Table, orders: Table, customer: Table, *, quantity: int, mesh) -> Table:
    """Q18: the orders whose lines' quantities sum past ``quantity`` (the
    subquery's group by l_orderkey and HAVING, densified), ORDERS
    semi-joined to them (an inner join: their keys are unique), joined to
    CUSTOMER, ordered by o_totalprice descending then o_orderdate, the
    first 100 rows.  Returns a Table of at most 100 rows.

    The outer group by is no operator: its key holds o_orderkey, a key of
    ORDERS, and each order appears once after the joins, so every group is
    one row and its sum(l_quantity) is the subquery's sum."""
    lines = Table({"o_orderkey": lineitem["l_orderkey"], "l_quantity": lineitem["l_quantity"]})
    sums, _ = _dt.distributed_group_aggregate(
        lines, "o_orderkey", {"sum_qty": ("l_quantity", "sum")}, mesh=mesh)
    del lines
    big, counts = _dt.distributed_filter(sums, sums["sum_qty"] > 100 * int(quantity),
                                         mesh=mesh)
    del sums
    big, _ = _dt.distributed_densify(big, counts, mesh=mesh)
    picked, _ = _dt.distributed_join(orders, big, "o_orderkey", mesh=mesh,
                                     capacity_factor=_JOIN_CAPACITY)
    picked = Table({"c_custkey": picked["o_custkey"],
                    **{c: picked[c] for c in Q18_COLUMNS[2:]}})
    named, _ = _dt.distributed_join(customer, picked, "c_custkey", mesh=mesh,
                                    capacity_factor=_JOIN_CAPACITY)
    ordered = _ops.sort_by(named.with_column("desc_price", -named["o_totalprice"]),
                           ["desc_price", "o_orderdate"])
    return Table({c: ordered[c][:_Q18_LIMIT] for c in Q18_COLUMNS})
