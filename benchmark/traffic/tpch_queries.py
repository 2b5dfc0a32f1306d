"""A closed-loop TPC-H query stream through the program's plans,
``rdst_tpu_torch.table.tpch.q1`` and ``q18``, over tables made on the card
from the seed (``reference/tpch_queries.py``) and held there, on a mesh of
``shards`` shards on the card; and the plain reference of both queries.

Traffic parameters (``traffic/<name>.json``):

    ops          the queries of one unit of the stream, in order
    delta_days   [lo, hi]: Q1's DELTA, drawn for each call, uniform
    quantity     [lo, hi]: Q18's QUANTITY, drawn for each call, uniform
    shards       the mesh's shards on the card (``make_mesh(shards)``)
    warm_calls   calls of each query in the warm-up
    trace_calls  calls in the traced stretch (whole units)
    keep         how many answers of each query are judged besides the
                 window's last: calls drawn from the seed over the window

Configuration (``configs/<name>.json``): ``scale_factor``, ``chunk``,
``chunks`` (dbgen's ``-s``, ``-S``, ``-C``).

The window's parameters come from the seed alone: the schedule draws each
unit's before yielding it.  Calls outside the window (the warm-up, the
traced stretch) draw from a stream of their own.

The check runs the plain reference on the same tables and parameters.
``wrong_q1_values``: cells of Q1's answer (4 rows by 10 columns) that
differ from the reference's, a missing or extra row counting 10.
``wrong_q18_rows``: rows of Q18's answer that are not the reference's: the
(o_totalprice, o_orderdate) sequence must be the reference's, and rows tied
on it may come in any order, each row's C_NAME decoded from its code.  The
control puts the plain reference with every sum in float32 in the
program's place.
"""
from __future__ import annotations

import collections
import random
from pathlib import Path

import torch

import bench_core

ref = bench_core.module("reference", "tpch_queries", Path(__file__).resolve().parent.parent)
OPS = ("q1", "q18")
#: Each compared number and its limit: exact answers, so 0.
LIMITS = {"wrong_q1_values": 0, "wrong_q18_rows": 0}
LIMIT_ROWS = 100  # Q18's LIMIT


class State:
    pass


def setup(config, traffic, seed, devs) -> State:
    from rdst_tpu_torch.parallel import make_mesh
    from rdst_tpu_torch.table import Table, tpch

    s = State()
    s.tpch, s.traffic, s.dev = tpch, traffic, devs.list[0]
    s.data = ref.generate(config["scale_factor"], config["chunk"], config["chunks"], seed,
                          s.dev)
    s.tables = tuple(Table(d) for d in s.data)
    s.mesh = make_mesh(traffic["shards"], device=s.dev)
    s.outside = random.Random(f"{seed}:outside the window")
    s.pending = []  # (op, parameter) of the window's unit under way
    s.last = None  # (op, parameter) of the last call
    return s


def _draw(rng, traffic, op):
    lo, hi = traffic["quantity" if op == "q18" else "delta_days"]
    return rng.randint(lo, hi)


def ops(s):
    return list(OPS)


def rows(s):
    """Rows a call reads: Q1 LINEITEM's, Q18 LINEITEM's, ORDERS' and
    CUSTOMER's."""
    n = [int(next(iter(d.values())).shape[0]) for d in s.data]
    return {"q1": n[0], "q18": sum(n)}


def schedule(s, traffic, seed):
    rng = random.Random(f"{seed}:window")
    while True:
        unit = list(traffic["ops"])
        s.pending = [(op, _draw(rng, traffic, op)) for op in unit]
        yield unit


def trace_ops(s, traffic):
    ops_ = list(traffic["ops"])
    return ops_ * (traffic["trace_calls"] // len(ops_))


def _parameter(s, op):
    if s.pending and s.pending[0][0] == op:
        return s.pending.pop(0)[1]
    return _draw(s.outside, s.traffic, op)


def call(s, op):
    p = _parameter(s, op)
    s.last = (op, p)
    lineitem, orders, customer = s.tables
    if op == "q1":
        return s.tpch.q1(lineitem, delta_days=p, mesh=s.mesh)
    return s.tpch.q18(lineitem, orders, customer, quantity=p, mesh=s.mesh)


def control_call(s, op):
    p = _parameter(s, op)
    s.last = (op, p)
    li, od, cu = s.data
    if op == "q1":
        return ref.q1_plain(li, p, sum_dtype=torch.float32)
    return ref.q18_plain(li, od, cu, p, sum_dtype=torch.float32)


def _columns(out) -> dict:
    return out if isinstance(out, dict) else {c: out[c] for c in out.column_names}


#: The columns each query references, by table (LINEITEM, ORDERS, CUSTOMER).
_READS = {"q1": (("l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
                  "l_linestatus", "l_shipdate"), (), ()),
          "q18": (("l_orderkey", "l_quantity"), ref.ORDERS, ref.CUSTOMER)}


def shapes(s, op, out):
    """The call's columns: (rows, bytes a row) of each referenced input
    column and of each column of its answer."""
    inputs = {}
    for table, names in zip(s.data, _READS[op]):
        for c in names:
            inputs[c] = (int(table[c].shape[0]), table[c].element_size())
    cols = _columns(out)
    return {"in": inputs, "out": {c: (int(v.shape[0]), v.element_size()) for c, v in cols.items()}}


def keep(s, op, out):
    """The answer where the call left it, with the call's parameter."""
    return (s.last[1], _columns(out))


def setup_note(s):
    n = rows(s)
    gb = sum(v.numel() * v.element_size() for d in s.data for v in d.values()) / 1e9
    return (f"bench: tpch_queries: LINEITEM {n['q1']} rows, ORDERS and CUSTOMER "
            f"{n['q18'] - n['q1']} rows, {gb:.3f} GB on {s.dev}; "
            f"make_mesh({s.traffic['shards']})")


def release(s):
    """Drop what the program made; the tables stay for the reference."""
    s.tables = s.mesh = s.tpch = None


def _n_rows(cols: dict) -> int:
    return int(next(iter(cols.values())).shape[0]) if cols else 0


def wrong_q1_values(got: dict, want: dict) -> int:
    n = min(_n_rows(got), _n_rows(want))
    bad = len(ref.Q1_COLUMNS) * abs(_n_rows(got) - _n_rows(want))
    for c in ref.Q1_COLUMNS:
        if c not in got:
            bad += n
            continue
        g, w = got[c][:n].to(want[c].device), want[c][:n]
        bad += n if g.dtype != w.dtype else int((g != w).sum())
    return bad


def _q18_rows(cols: dict, names) -> list:
    """Rows as tuples, C_NAME decoded (``names``: custkey of each code)."""
    out = []
    host = {c: cols[c].cpu().tolist() for c in ref.Q18_COLUMNS if c in cols}
    for i in range(_n_rows(cols)):
        row = tuple(host[c][i] if c in host else None for c in ref.Q18_COLUMNS)
        code = row[0]
        known = isinstance(code, int) and 0 <= code < len(names)
        out.append(("Customer#%09d" % names[code] if known else code,) + row[1:])
    return out


def wrong_q18_rows(got: list, want: list, limit: int = LIMIT_ROWS) -> int:
    """Rows of ``got`` that are not the reference's first ``limit``:
    ``want`` is every qualifying row in the reference's order, so rows tied
    on (o_totalprice, o_orderdate) across the limit are matched too."""
    n = min(limit, len(want))
    bad = abs(len(got) - n)
    ties = collections.defaultdict(collections.Counter)

    def key(r):
        return r[4], r[3]  # o_totalprice, o_orderdate

    for r in want:
        ties[key(r)][r] += 1
    for i, r in enumerate(got[:n]):
        if key(r) != key(want[i]) or ties[key(r)][r] == 0:
            bad += 1
        else:
            ties[key(r)][r] -= 1
    return bad


def check(s, kept, devs):
    li, od, cu = s.data
    names = torch.empty_like(cu["c_custkey"])
    names[cu["c_name"].to(torch.int64)] = cu["c_custkey"]
    names = names.cpu().tolist()  # custkey of each code
    wrong = dict.fromkeys(LIMITS, 0)
    wrong_answers = 0
    answers = len(kept)
    while kept:
        op, (p, got) = kept.pop(0)
        if op == "q1":
            bad = wrong_q1_values(got, ref.q1_plain(li, p))
            wrong["wrong_q1_values"] += bad
        else:
            want = ref.q18_plain(li, od, cu, p, limit=None)
            bad = wrong_q18_rows(_q18_rows(got, names), _q18_rows(want, names))
            wrong["wrong_q18_rows"] += bad
        wrong_answers += bad > 0
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in wrong.items()}
    return {"checks": checks, "wrong_answers": wrong_answers, "answers": answers}
