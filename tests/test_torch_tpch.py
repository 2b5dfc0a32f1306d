"""TPC-H Q1 and Q18 as the port's plans (``rdst_tpu_torch.table.tpch``)
against the plain reference of ``tests/tpch_plain.py``, on meshes of 8
shards and of 1 on the CPU, at SF 0.002 (chunks of 750 orders) with the
fused executor's threshold lowered so that Q18's aggregate takes B2/B3's
route and Q1's eleven planes take ``lex_sort``'s; the repairs the plans
needed in the operators (tables of any length, a filter's counts into the
aggregate, the densified filter); the generator's invariants; and the
plans' spans."""
import datetime
import fractions

import pytest
import torch

import tpch_plain as tp
from rdst_tpu_torch import config
from rdst_tpu_torch.parallel import dtable as td
from rdst_tpu_torch.parallel import make_mesh
from rdst_tpu_torch.parallel import shuffle as sh
from rdst_tpu_torch.table import Table, ops, tpch
from rdst_tpu_torch.utils import trace

SF = 0.002
SEEDS = (2**31 + 3, 2**31 + 4)


@pytest.fixture(autouse=True)
def executor(monkeypatch):
    """B2/B3 (their plain versions here) for shards of a few hundred rows."""
    monkeypatch.setattr(config, "fused_min_elems", 256)
    monkeypatch.setattr(config, "fused_min_piece", 256)
    monkeypatch.setattr(config, "bitonic_smem_bytes", 18432)


@pytest.fixture(scope="module")
def meshes():
    return {8: make_mesh(8, device="cpu"), 1: make_mesh(1, device="cpu")}


_DATA = {}


def data(chunk, seed):
    if (chunk, seed) not in _DATA:
        _DATA[chunk, seed] = tp.generate(SF, chunk, 4, seed)
    return _DATA[chunk, seed]


def tables(chunk, seed):
    return tuple(Table(d, device="cpu") for d in data(chunk, seed))


def _equal(got: Table, want: dict, columns):
    assert got.column_names == list(columns)
    for c in columns:
        assert got[c].dtype == want[c].dtype, c
        assert torch.equal(got[c], want[c]), (c, got[c], want[c])


def _delta_on_a_ship_date(lineitem):
    """A DELTA in [60, 120] whose cutoff is some line's ship date."""
    ship = lineitem["l_shipdate"]
    hit = ship[(ship >= tp.Q1_BASE - 120) & (ship <= tp.Q1_BASE - 60)]
    assert hit.numel(), "no ship date in Q1's window"
    return tp.Q1_BASE - int(hit[0])


@pytest.mark.parametrize("D", [8, 1])
@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_q1_equals_the_reference(meshes, D, chunk, seed):
    li = data(chunk, seed)[0]
    lineitem = tables(chunk, seed)[0]
    delta = _delta_on_a_ship_date(li)
    assert (li["l_shipdate"] == tpch.q1_cutoff(delta)).any()  # the <= is tested
    for d in (delta, 120):
        _equal(tpch.q1(lineitem, delta_days=d, mesh=meshes[D]), tp.q1_plain(li, d),
               tp.Q1_COLUMNS)


@pytest.mark.parametrize("D", [8, 1])
@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_q18_equals_the_reference(meshes, D, chunk, seed):
    li, od, cu = data(chunk, seed)
    lineitem, orders, customer = tables(chunk, seed)
    sizes = []
    for q in (150, 200, 250):
        got = tpch.q18(lineitem, orders, customer, quantity=q, mesh=meshes[D])
        _equal(got, tp.q18_plain(li, od, cu, q), tp.Q18_COLUMNS)
        sizes.append(got.n_rows)
    assert sizes[0] == 100 and sizes[1] > 0  # the limit and a non-empty answer


def test_the_routes_of_both_queries(meshes):
    """Q18's aggregate (orderkey and quantity, 4 planes) takes B2/B3; Q1's
    (one key word and ten payload words) takes lex_sort."""
    lineitem, orders, customer = tables(1, SEEDS[0])
    n = lineitem.n_rows
    sh.SORT_ROUTES.clear()
    tpch.q18(lineitem, orders, customer, quantity=200, mesh=meshes[8])
    assert sh.SORT_ROUTES[(4, -(-n // 8), "B2/B3")] == 8
    sh.SORT_ROUTES.clear()
    tpch.q1(lineitem, delta_days=90, mesh=meshes[8])
    assert sh.SORT_ROUTES[(11, -(-n // 8), "lex_sort")] == 8


def _order_key(t, i):
    return int(t["o_totalprice"][i]), int(t["o_orderdate"][i])


def _rows(t, idx):
    return sorted(tuple(int(t[c][i]) for c in tp.Q18_COLUMNS) for i in idx)


def test_q18_rows_tied_on_price_and_date(meshes):
    """Two qualifying orders made to tie on (o_totalprice, o_orderdate)
    come back side by side, in either order."""
    li, od, cu = (dict(x) for x in data(1, SEEDS[0]))
    want = tp.q18_plain(li, od, cu, 150, limit=None)
    assert want["o_orderkey"].numel() >= 2
    a, b = (torch.nonzero(od["o_orderkey"] == want["o_orderkey"][i]).item() for i in (0, 1))
    od = {c: v.clone() for c, v in od.items()}
    od["o_totalprice"][b] = od["o_totalprice"][a]
    od["o_orderdate"][b] = od["o_orderdate"][a]
    want = tp.q18_plain(li, od, cu, 150)
    got = tpch.q18(Table(li, device="cpu"), Table(od, device="cpu"), Table(cu, device="cpu"),
                   quantity=150, mesh=meshes[8])
    assert got.n_rows == want["o_orderkey"].numel()
    keys = [_order_key(got, i) for i in range(got.n_rows)]
    assert keys == [_order_key(want, i) for i in range(got.n_rows)]
    assert keys[0] == keys[1]
    assert _rows(got, range(2)) == _rows(want, range(2))
    assert _rows(got, range(got.n_rows)) == _rows(want, range(got.n_rows))


def test_averages_are_float64_quotients_of_exact_sums(meshes):
    """Q1's averages are float64(sum) / float64(count); the engine's
    float32 ``mean`` does not give them."""
    li = data(3, SEEDS[1])[0]
    got = tpch.q1(tables(3, SEEDS[1])[0], delta_days=90, mesh=meshes[8])
    n = got["count_order"].to(torch.float64)
    assert torch.equal(got["avg_qty"], got["sum_qty"].to(torch.float64) / n)
    assert torch.equal(got["avg_price"], got["sum_base_price"].to(torch.float64) / n)
    m = li["l_shipdate"] <= tpch.q1_cutoff(90)
    kept = Table({c: li[c][m] for c in ("l_returnflag", "l_linestatus", "l_quantity",
                                         "l_extendedprice")}, device="cpu")
    f32, _ = td.distributed_group_aggregate(
        kept, ["l_returnflag", "l_linestatus"],
        {"q": ("l_quantity", "mean"), "p": ("l_extendedprice", "mean")}, mesh=meshes[8])
    f32 = ops.sort_by(f32, ["l_returnflag", "l_linestatus"])
    assert f32["q"].dtype == torch.float32
    assert not (torch.equal(f32["q"].to(torch.float64), got["avg_qty"])
                and torch.equal(f32["p"].to(torch.float64), got["avg_price"]))


def test_sum_charge_of_the_largest_group_fits_int64():
    """The cell's chunk (SF 100, 1 of 4): (N, O) is Q1's largest group, the
    lines shipped after 1995-06-17.  Even with every one of its lines at
    the generator's largest charge, its sum_charge stays under 2^63."""
    retail_max = 90000 + 20000 + 100 * 999
    charge_max = 50 * retail_max * (100 - 0) * (100 + 8)  # 10^-6 dollars
    assert int(tp.retail_price(torch.arange(1, 20_000_001, 9)).max()) <= retail_max
    # P(shipdate > CURRENTDATE), exactly, over the uniform order and ship days
    span = tp.LAST_ORDERDATE - tp.STARTDATE + 1
    late = sum(fractions.Fraction(sum(1 for d in range(1, 122) if o + d > tp.CURRENTDATE), 121)
               for o in range(tp.STARTDATE, tp.LAST_ORDERDATE + 1)) / span
    lo, hi = tp.chunk_range(100, 1, 4)
    lines = (hi - lo) * 4  # 1-7 lines an order, 4 on average
    group = int(lines * late * 1.01)  # a hundredth more than expected: 200 sd
    assert 7.0e7 < group < 7.7e7
    assert group * charge_max < 2**63
    li = tp.generate(0.01, 1, 4, SEEDS[0])[0]
    charge = li["l_extendedprice"] * (100 - li["l_discount"]) * (100 + li["l_tax"])
    assert int(charge.max()) <= charge_max


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_invariants(seed):
    li, od, cu = tp.generate(SF, 2, 4, seed)
    n_cust = tp.scaled(tp.CUSTOMERS_PER_SF, SF)
    lo, hi = tp.chunk_range(SF, 2, 4)
    row = torch.arange(lo + 1, hi + 1)
    ok = od["o_orderkey"]
    assert torch.equal(ok, ((row >> 3) << 5) | (row & 7))
    assert bool((ok % 32 < 8).all()) and bool((ok[1:] > ok[:-1]).all())
    ck = od["o_custkey"]
    assert bool(((ck >= 1) & (ck <= n_cust) & (ck % 3 != 0)).all())
    d = od["o_orderdate"]
    assert int(d.min()) >= tp.STARTDATE and int(d.max()) <= tp.LAST_ORDERDATE
    # lines: each order's together, in key order, 1-7 of them
    lk = li["l_orderkey"]
    assert bool((lk[1:] >= lk[:-1]).all())
    keys, per_order = torch.unique_consecutive(lk, return_counts=True)
    assert torch.equal(keys, ok) and int(per_order.min()) >= 1 and int(per_order.max()) <= 7
    q = li["l_quantity"]
    assert bool((q % 100 == 0).all()) and int(q.min()) >= 100 and int(q.max()) <= 5000
    retail = li["l_extendedprice"] // (q // 100)
    assert torch.equal(retail * (q // 100), li["l_extendedprice"])
    assert int(retail.min()) >= 90000 and int(retail.max()) <= 209900
    assert int(li["l_discount"].min()) >= 0 and int(li["l_discount"].max()) <= 10
    assert int(li["l_tax"].min()) >= 0 and int(li["l_tax"].max()) <= 8
    owner = torch.repeat_interleave(torch.arange(ok.numel()), per_order)
    lag = li["l_shipdate"] - d[owner]
    assert int(lag.min()) >= 1 and int(lag.max()) <= 121
    ship, flag, status = li["l_shipdate"], li["l_returnflag"], li["l_linestatus"]
    assert torch.equal(status, torch.where(ship > tp.CURRENTDATE, ord("O"), ord("F"))
                       .to(torch.uint8))
    assert set(flag.tolist()) <= {ord("R"), ord("A"), ord("N")}
    received = ship + 30 <= tp.CURRENTDATE  # the receipt date is at most 30 days later
    assert bool((flag[received] != ord("N")).all())
    assert bool((flag[ship >= tp.CURRENTDATE] == ord("N")).all())
    t = li["l_extendedprice"] * (100 - li["l_discount"]) // 100 * (100 + li["l_tax"]) // 100
    assert torch.equal(od["o_totalprice"], torch.zeros(ok.numel(), dtype=torch.int64)
                       .index_add_(0, owner, t))
    assert torch.equal(cu["c_custkey"], torch.arange(1, n_cust + 1))
    assert torch.equal(torch.sort(cu["c_name"]).values, torch.arange(n_cust, dtype=torch.int32))
    code = int(cu["c_name"][41])
    assert tp.customer_name(cu, code) == "Customer#000000042"
    # the same seed repeats, another seed differs, the chunks tile the orders
    again = tp.generate(SF, 2, 4, seed)
    assert all(torch.equal(a[c], b[c]) for a, b in zip((li, od, cu), again) for c in a)
    other = tp.generate(SF, 2, 4, seed + 1)[1]
    assert not torch.equal(other["o_orderdate"], d)
    every = torch.cat([tp.generate(SF, k, 4, seed)[1]["o_orderkey"] for k in (1, 2, 3, 4)])
    whole = torch.arange(1, tp.scaled(tp.ORDERS_PER_SF, SF) + 1)
    assert torch.equal(every, ((whole >> 3) << 5) | (whole & 7))
    assert datetime.date(1970, 1, 1) + datetime.timedelta(tp.CURRENTDATE) == \
        datetime.date(1995, 6, 17)


# ---------------------------------------------------------------------------
# The operators' repairs
# ---------------------------------------------------------------------------


def _rows_of(t: Table, names):
    return sorted(zip(*(t[c].tolist() for c in names)))


@pytest.mark.parametrize("n", [0, 5, 61, 64])
def test_operators_take_tables_of_any_length(meshes, n):
    """A table whose length the 8 shards do not divide (none, fewer rows
    than shards, or a remainder) is padded inside the operator, and the
    rows appended take part in nothing."""
    g = torch.Generator().manual_seed(n)
    k = torch.randint(0, 40, (n,), generator=g)
    t = Table({"k": k, "v": torch.randint(-50, 50, (n,), generator=g),
               "f": torch.randint(0, 3, (n,), generator=g).to(torch.uint8)}, device="cpu")
    mesh = meshes[8]
    agg, groups = td.distributed_group_aggregate(
        t, ["f", "k"], {"s": ("v", "sum"), "c": (None, "count")}, mesh=mesh)
    want, count = ops.group_aggregate(t, ["f", "k"], {"s": ("v", "sum"), "c": (None, "count")})
    assert int(groups) == int(count)
    want = Table({c: want[c][:int(count)] for c in want.column_names})
    assert _rows_of(agg, ["f", "k", "s", "c"]) == _rows_of(want, ["f", "k", "s", "c"])
    kept, counts = td.distributed_filter(t, t["v"] > 0, mesh=mesh)
    assert kept.n_rows == max(-(-n // 8), 1) * 8 and int(counts.sum()) == int((t["v"] > 0).sum())
    dense, m = td.distributed_densify(kept, counts, mesh=mesh)
    assert m == dense.n_rows and _rows_of(dense, ["k", "v"]) == \
        sorted(zip(k[t["v"] > 0].tolist(), t["v"][t["v"] > 0].tolist()))
    right = Table({"k": torch.arange(30), "w": torch.arange(30) * 10}, device="cpu")
    joined, matched = td.distributed_join(t, right, "k", mesh=mesh)
    want, _ = ops.join(t, right, "k")
    assert matched == want.n_rows
    assert _rows_of(joined, ["k", "v", "w"]) == _rows_of(want, ["k", "v", "w"])
    out, c = td.distributed_sort_table(t, "k", mesh=mesh)
    cap = out.n_rows // 8
    got = torch.cat([out["k"][d * cap:d * cap + int(c[d])] for d in range(8)])
    assert torch.equal(got, torch.sort(k).values)


def test_aggregate_takes_a_filters_counts(meshes):
    """The rows past each shard's count (the filter's dropped rows) are
    left out of the aggregate, without a host read."""
    li = data(1, SEEDS[0])[0]
    n = li["l_orderkey"].numel() // 8 * 8
    t = Table({c: li[c][:n] for c in ("l_orderkey", "l_quantity")}, device="cpu")
    keep = t["l_quantity"] > 2500
    kept, counts = td.distributed_filter(t, keep, mesh=meshes[8])
    got, _ = td.distributed_group_aggregate(kept, "l_orderkey", {"s": ("l_quantity", "sum")},
                                            mesh=meshes[8], counts=counts)
    ref = Table({c: t[c][keep] for c in t.column_names}, device="cpu")
    want, groups = td.distributed_group_aggregate(ref, "l_orderkey",
                                                  {"s": ("l_quantity", "sum")}, mesh=meshes[8])
    assert got.n_rows == int(groups)
    assert torch.equal(got["l_orderkey"], want["l_orderkey"]) and torch.equal(got["s"], want["s"])


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


def _spans(fn):
    """(name, parent span's name) of every ``rdst.*`` span of ``fn()``
    under a CPU profiler, in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    ev = sorted((e.start_ns(), -e.end_ns(), e.name())
                for e in prof.profiler.kineto_results.events() if e.name().startswith("rdst."))
    stack, out = [], []
    for s, neg_end, name in ev:
        while stack and stack[-1][1] < s:
            stack.pop()
        out.append((name, [n for n, _ in stack]))
        stack.append((name, -neg_end))
    return out


def test_query_spans_nest(meshes):
    lineitem, orders, customer = tables(1, SEEDS[0])
    q18 = _spans(lambda: tpch.q18(lineitem, orders, customer, quantity=150, mesh=meshes[8]))
    q1 = _spans(lambda: tpch.q1(lineitem, delta_days=90, mesh=meshes[8]))
    for spans, query in ((q18, "rdst.query.q18"), (q1, "rdst.query.q1")):
        assert spans[0] == (query, [])
        assert all(anc and anc[0] == query for _, anc in spans[1:])
        for name, anc in spans:
            if name.startswith("rdst.shuffle."):
                assert "rdst.shuffle" in anc, name
            if name.startswith("rdst.sync."):  # a read is no parent
                assert not any(n == name for n, a in spans if name in a)
    names18 = {n for n, _ in q18}
    assert {"rdst.table.encode", "rdst.table.aggregate", "rdst.table.filter", "rdst.table.join",
            "rdst.table.densify", "rdst.shuffle", "rdst.shuffle.sort.fused",
            "rdst.shuffle.sort.lex", "rdst.shuffle.plan", "rdst.shuffle.exchange",
            "rdst.fused_sort", "rdst.sync.capacity", "rdst.sync.read_gathered",
            "rdst.sync.densify"} <= names18
    # Q18: two reads an aggregate or join (capacity, gathered counts), one densify
    assert sum(n.startswith("rdst.sync.") for n, _ in q18) == 7
    assert sum(n.startswith("rdst.sync.") for n, _ in q1) == 2
    assert sum(n == "rdst.shuffle.sort.lex" for n, _ in q1) == 16
    fused = [a for n, a in q18 if n == "rdst.fused_sort"]
    assert fused and all("rdst.shuffle.sort.fused" in a for a in fused)


def test_no_span_is_recorded_without_a_profiler(meshes, monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: calls.append(name) or real(name, *a))
    lineitem, orders, customer = tables(3, SEEDS[1])
    tpch.q1(lineitem, delta_days=60, mesh=meshes[8])
    tpch.q18(lineitem, orders, customer, quantity=200, mesh=meshes[8])
    assert calls == []
    assert trace.span("query.q1") is trace._OFF
