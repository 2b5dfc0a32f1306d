"""TPC-H tables for Q1 and Q18 from a seed, and the two queries in plain
PyTorch: the reference the port's plans (``rdst_tpu_torch.table.tpch``)
are held to.  Imports neither JAX nor ``rdst_tpu_torch``.

:func:`generate` makes chunk ``chunk`` of ``chunks`` (dbgen's ``-C chunks
-S chunk``: the orders, and their lines, in the chunk's share of the
order index range) at any scale factor, by the distributions of TPC
Benchmark H rev. 3.0.1 §4.2.3 for every column Q1 and Q18 reference, from
a seed on any device (torch's generator, not dbgen's random streams):

- O_ORDERKEY sparse as dbgen's ``mk_sparse`` makes it from the 1-based
  row index i: ``((i >> 3) << 5) | (i & 7)``, 8 keys of every 32;
- O_CUSTKEY uniform over [1, SF x 150,000] less the multiples of 3;
- O_ORDERDATE uniform in [1992-01-01, 1998-08-02];
- 1-7 lines an order; L_QUANTITY in [1, 50]; L_PARTKEY in
  [1, SF x 200,000]; L_EXTENDEDPRICE = quantity x P_RETAILPRICE(partkey),
  P_RETAILPRICE = (90000 + ((partkey / 10) mod 20001) + 100 x (partkey mod
  1000)) / 100; L_DISCOUNT in [0.00, 0.10]; L_TAX in [0.00, 0.08];
- L_SHIPDATE = orderdate + [1, 121]; L_RECEIPTDATE = shipdate + [1, 30]
  (made for the return flag, not kept); L_RETURNFLAG R or A if the receipt
  date is on or before 1995-06-17, else N; L_LINESTATUS O if the ship date
  is after 1995-06-17, else F;
- O_TOTALPRICE the sum over the order's lines of extendedprice x (1 -
  discount) x (1 + tax) in integer cents as dbgen's ``mk_order`` computes
  it: ``t = eprice * (100 - discount) // 100; t = t * (100 + tax) // 100``,
  each division truncating;
- CUSTOMER every customer (the table is replicated on every card): keys
  1..SF x 150,000 and C_NAME as an int32 dictionary code, a seeded
  permutation of the keys; :func:`customer_name` decodes a code to the
  specification's ``Customer#%09d``;
- rows in dbgen's order: orders by key, each order's lines together.

Types: decimals int64 fixed point (quantity, discount and tax in
hundredths, prices in cents), keys int64, flags uint8 (ASCII), dates int32
days since 1970-01-01.  Every random draw is uniform.

:func:`q1_plain` and :func:`q18_plain` are the queries by masks,
``index_add_`` and ``bincount`` sums (Q18's subquery over the dense
orderkey range), CUSTOMER indexed by custkey and ``torch.sort`` for the
final order; ``sum_dtype=torch.float32`` gives the control: every sum in
float32, which must come out wrong.
"""
from __future__ import annotations

import datetime

import torch

ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 150_000
PARTS_PER_SF = 200_000
_EPOCH = datetime.date(1970, 1, 1)


def days(y: int, m: int, d: int) -> int:
    """A date as int32 days since 1970-01-01."""
    return (datetime.date(y, m, d) - _EPOCH).days


STARTDATE = days(1992, 1, 1)
LAST_ORDERDATE = days(1998, 8, 2)  # ENDDATE - 151 days
CURRENTDATE = days(1995, 6, 17)
Q1_BASE = days(1998, 12, 1)
LINEITEM = ("l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_returnflag", "l_linestatus", "l_shipdate")
ORDERS = ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice")
CUSTOMER = ("c_custkey", "c_name")
Q1_COLUMNS = ("l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
              "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc",
              "count_order")
Q18_COLUMNS = ("c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice",
               "sum_qty")


def scaled(per_sf: int, sf: float) -> int:
    return int(round(per_sf * sf))


def chunk_range(sf: float, chunk: int, chunks: int) -> tuple[int, int]:
    """The 0-based order indices [lo, hi) of chunk ``chunk`` (1-based) of
    ``chunks``."""
    n = scaled(ORDERS_PER_SF, sf)
    return (chunk - 1) * n // chunks, chunk * n // chunks


def retail_price(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE in cents."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def _seed(seed: int, chunk: int, chunks: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + chunk * 0xBF58476D1CE4E5B9 + chunks) % (1 << 63)


def generate(sf: float, chunk: int, chunks: int, seed: int, device="cpu"):
    """(lineitem, orders, customer): dicts of column tensors on ``device``."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, chunk, chunks))
    i64 = torch.int64

    def draw(lo, hi, n, dtype=i64):  # uniform in [lo, hi]
        return torch.randint(lo, hi + 1, (n,), generator=gen, device=device, dtype=dtype)

    lo, hi = chunk_range(sf, chunk, chunks)
    n = hi - lo
    n_cust = scaled(CUSTOMERS_PER_SF, sf)
    row = torch.arange(lo + 1, hi + 1, device=device, dtype=i64)  # dbgen's 1-based index
    j = draw(0, n_cust - n_cust // 3 - 1, n)  # the j-th key that is no multiple of 3
    orders = {
        "o_orderkey": ((row >> 3) << 5) | (row & 7),
        "o_custkey": 3 * (j // 2) + 1 + j % 2,
        "o_orderdate": draw(STARTDATE, LAST_ORDERDATE, n, torch.int32),
    }
    del row, j
    owner = torch.repeat_interleave(torch.arange(n, device=device), draw(1, 7, n))
    m = int(owner.shape[0])
    qty = draw(1, 50, m)
    eprice = qty * retail_price(draw(1, scaled(PARTS_PER_SF, sf), m))
    disc, tax = draw(0, 10, m), draw(0, 8, m)
    ship = orders["o_orderdate"][owner] + draw(1, 121, m, torch.int32)
    receipt = ship + draw(1, 30, m, torch.int32)
    ra = torch.where(draw(0, 1, m) == 0, ord("R"), ord("A"))
    flag = torch.where(receipt <= CURRENTDATE, ra, ord("N")).to(torch.uint8)
    del receipt, ra
    status = torch.where(ship > CURRENTDATE, ord("O"), ord("F")).to(torch.uint8)
    line_total = eprice * (100 - disc) // 100 * (100 + tax) // 100
    orders["o_totalprice"] = torch.zeros(n, dtype=i64, device=device).index_add_(
        0, owner, line_total)
    del line_total
    lineitem = {
        "l_orderkey": orders["o_orderkey"][owner], "l_quantity": qty * 100,
        "l_extendedprice": eprice, "l_discount": disc, "l_tax": tax,
        "l_returnflag": flag, "l_linestatus": status, "l_shipdate": ship,
    }
    customer = {
        "c_custkey": torch.arange(1, n_cust + 1, device=device, dtype=i64),
        "c_name": torch.randperm(n_cust, generator=gen, device=device).to(torch.int32),
    }
    return lineitem, orders, customer


def customer_name(customer: dict, code: int) -> str:
    """The specification's C_NAME of the customer whose code is ``code``."""
    key = customer["c_custkey"][customer["c_name"] == code]
    return "Customer#%09d" % int(key[0])


def q1_plain(lineitem: dict, delta_days: int, sum_dtype=torch.int64) -> dict:
    """Q1's answer, rows by (l_returnflag, l_linestatus); sums as int64
    (the control's float32 sums cast to int64)."""
    li = lineitem
    m = li["l_shipdate"] <= Q1_BASE - delta_days
    flag, status = li["l_returnflag"][m], li["l_linestatus"][m]
    gid = flag.to(torch.int64) * 256 + status.to(torch.int64)
    keys, inv = torch.unique(gid, sorted=True, return_inverse=True)
    price, disc = li["l_extendedprice"][m], li["l_discount"][m]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + li["l_tax"][m])

    def total(x):
        s = torch.zeros(keys.shape[0], dtype=sum_dtype, device=x.device)
        return s.index_add_(0, inv, x.to(sum_dtype)).to(torch.int64)

    count = torch.bincount(inv, minlength=keys.shape[0]).to(torch.int64)
    out = {"l_returnflag": (keys // 256).to(torch.uint8),
           "l_linestatus": (keys % 256).to(torch.uint8),
           "sum_qty": total(li["l_quantity"][m]), "sum_base_price": total(price),
           "sum_disc_price": total(disc_price), "sum_charge": total(charge)}
    sum_disc = total(disc)
    for name, s in (("avg_qty", out["sum_qty"]), ("avg_price", out["sum_base_price"]),
                    ("avg_disc", sum_disc)):
        out[name] = s.to(torch.float64) / count.to(torch.float64)
    out["count_order"] = count
    return out


def q18_plain(lineitem: dict, orders: dict, customer: dict, quantity: int,
              limit: int | None = 100, sum_dtype=torch.int64) -> dict:
    """Q18's answer in its order (o_totalprice descending, then
    o_orderdate; ties in orderkey order), the first ``limit`` rows (None:
    every row)."""
    keys = lineitem["l_orderkey"]
    top = int(keys.max()) + 1 if keys.numel() else 1
    sums = torch.zeros(top, dtype=sum_dtype, device=keys.device).index_add_(
        0, keys, lineitem["l_quantity"].to(sum_dtype))
    big = sums > 100 * quantity
    okey = orders["o_orderkey"]
    sel = big[okey.clamp(max=top - 1)] & (okey < top)
    o = {c: orders[c][sel] for c in ORDERS}
    where = torch.full((int(customer["c_custkey"].max()) + 1,), -1, dtype=torch.int64,
                       device=keys.device)
    where[customer["c_custkey"]] = torch.arange(customer["c_custkey"].shape[0],
                                                device=keys.device)
    rows = {"c_name": customer["c_name"][where[o["o_custkey"]]], "c_custkey": o["o_custkey"],
            "o_orderkey": o["o_orderkey"], "o_orderdate": o["o_orderdate"],
            "o_totalprice": o["o_totalprice"],
            "sum_qty": sums[o["o_orderkey"]].to(torch.int64)}
    idx = torch.sort(rows["o_orderdate"], stable=True).indices
    idx = idx[torch.sort(-rows["o_totalprice"][idx], stable=True).indices]
    if limit is not None:
        idx = idx[:limit]
    return {c: rows[c][idx] for c in Q18_COLUMNS}
