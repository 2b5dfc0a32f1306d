"""The TPC-H cell (``tpch_q1_q18_1card``) on CPU entries at SF 0.002: a
sound run is correct and its traced run reads the three query metrics;
the parameters and the schedule come from the seed alone; the control
and a wrong answer come out not correct; and the query readers on
hand-built readings, None on a program without the spans."""
import copy
import time

import pytest

import bench_core as core
import bench_testing  # noqa: F401  (one thread a test process)
from bench_trace import DeviceOp, Reading

CELL = "tpch_q1_q18_1card"
SEED = 2**31 + 29
KIND = core.module("traffic", "tpch_queries")
QUERY_METRICS = ("idle_ms_per_query.shuffle", "idle_ms_per_query.operators",
                 "lex_sorts_per_query")


def _small(quantity=(150, 160)):
    c = core.cell_file(CELL)
    config = copy.deepcopy(core.config_file(c["config"]))
    traffic = copy.deepcopy(core.traffic_file(c["traffic"]))
    config["scale_factor"] = 0.002
    traffic.update(keep=2, warm_calls=1, quantity=list(quantity))
    return config, traffic


def _run(program="port", trace=False, seconds=0.5, **kw):
    config, traffic = _small(**kw)
    res = core.run_cell(CELL, config, traffic, seed=SEED, seconds=seconds, trace=trace,
                        devices=["cpu"], t_process=time.monotonic(), program=program,
                        log=lambda *a: None)
    res["correct"] = core.correct(res)
    return res


def test_a_sound_run_is_correct_and_its_trace_reads_the_query_metrics():
    res = _run(trace=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"wrong_q1_values", "wrong_q18_rows"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    run = res["run"]
    assert {s.op for s in run.spans} == {"q1", "q18"}
    manifest = core.load_json(core.HERE.parent / "BENCHMARK.json")
    values = core.metric_values(run, core.reported(manifest, CELL, "per_layer"))
    assert set(QUERY_METRICS) | {"host_syncs_per_call"} <= set(values)
    # the traced stretch: two units of the stream, Q1's 16 sorts by lex_sort
    assert [op for op, _, _ in run.profile.ops] == ["q18", "q1", "q18", "q1"]
    assert values["lex_sorts_per_query"]["value"] >= 8
    assert values["host_syncs_per_call"]["value"] == (7 + 2) / 2


def test_parameters_and_schedule_come_from_the_seed_alone():
    _, traffic = _small()

    def units(seed, n=6):
        s = KIND.State()
        s.pending = []
        g = KIND.schedule(s, traffic, seed)
        out = []
        for _ in range(n):
            out.append((next(g), list(s.pending)))
        return out

    a = units(SEED)
    assert a == units(SEED) and a != units(SEED + 1)
    for unit, pending in a:
        assert unit == ["q18", "q1"] and [op for op, _ in pending] == unit
        (_, q), (_, d) = pending
        assert 150 <= q <= 160 and 60 <= d <= 120
    full = core.traffic_file("tpch_stream_q18_q1")
    assert full["quantity"] == [312, 315] and full["delta_days"] == [60, 120]


def test_the_control_is_not_correct():
    res = _run(program="control")
    assert not res["correct"]
    assert res["checks"]["wrong_q1_values"]["value"] > 0


@pytest.mark.parametrize("query", ["q1", "q18"])
def test_a_wrong_answer_fails_the_run(monkeypatch, query):
    from rdst_tpu_torch.table import Table, tpch

    real = getattr(tpch, query)
    column = "sum_charge" if query == "q1" else "sum_qty"

    def altered(*args, **kw):
        out = real(*args, **kw)
        cols = {c: out[c].clone() for c in out.column_names}
        cols[column][-1] += 1
        return Table(cols)

    assert _run()["correct"]
    monkeypatch.setattr(tpch, query, altered)
    res = _run()
    assert not res["correct"]
    name = "wrong_q1_values" if query == "q1" else "wrong_q18_rows"
    assert res["checks"][name]["value"] > 0


def test_q18_rows_tied_on_price_and_date_match_in_any_order():
    want = [("a", 1, 10, 5, 100, 3), ("b", 2, 11, 5, 100, 4), ("c", 3, 12, 6, 90, 5)]
    assert KIND.wrong_q18_rows([want[1], want[0], want[2]], want) == 0
    assert KIND.wrong_q18_rows([want[0], want[2]], want) == 2  # a row missing
    assert KIND.wrong_q18_rows([want[0], want[0], want[2]], want) == 1
    # a tie across the limit: either tied row may be the last one kept
    assert KIND.wrong_q18_rows([want[1]], want, limit=1) == 0
    assert KIND.wrong_q18_rows([want[2]], want, limit=1) == 1


# ---------------------------------------------------------------------------
# The readers on hand-built readings
# ---------------------------------------------------------------------------


def _query(t0):
    """One query's spans from t0 (ns), nested as the program records them,
    with torch's own events inside."""
    return [
        ("rdst.query.q18", t0, t0 + 1000),
        ("rdst.table.encode", t0 + 10, t0 + 60),
        ("rdst.keys.normalize", t0 + 20, t0 + 50),
        ("rdst.shuffle", t0 + 100, t0 + 700),
        ("rdst.shuffle.sort.lex", t0 + 110, t0 + 200),
        ("rdst.shuffle.sort.fused", t0 + 210, t0 + 400),
        ("rdst.fused_sort", t0 + 220, t0 + 390),
        ("rdst.shuffle.plan", t0 + 410, t0 + 500),
        ("rdst.shuffle.exchange", t0 + 510, t0 + 600),
        ("cudaLaunchKernel", t0 + 520, t0 + 530),
        ("rdst.sync.capacity", t0 + 710, t0 + 750),
        ("rdst.table.aggregate", t0 + 760, t0 + 900),
        ("rdst.sync.read_gathered", t0 + 910, t0 + 950),
    ]


def _kernel(a, b):
    return DeviceOp("k", "kernel", 0, a, b)


def _read(name, reading):
    run = core.Run(CELL, {}, {}, [], 1.0, 1.0, [0], {}, reading)
    return core.module("metrics", name).read(run)


def test_a_gap_goes_to_the_layer_of_the_innermost_span():
    # gaps: in normalize (operators), in the fused sort (shuffle), in the
    # exchange under a launch (shuffle), in the capacity read (the shuffle
    # span ended: the query, operators), after the query (no layer)
    gaps = [(30, 40), (300, 320), (520, 540), (720, 740), (1050, 1150)]
    busy, t = [], 0
    for a, b in gaps:
        busy.append(_kernel(t, a))
        t = b
    busy.append(_kernel(t, 1200))
    r = Reading(0, 1200, [("q18", 0, 1000)], busy, _query(0), 1)
    assert _read("idle_ms_per_query.shuffle", r) == pytest.approx(40e-6)
    assert _read("idle_ms_per_query.operators", r) == pytest.approx(30e-6)
    assert _read("lex_sorts_per_query", r) == 1


def test_the_readers_return_none_without_query_spans():
    sort_call = [("rdst.sort", 0, 900), ("rdst.sorter.run", 10, 800), ("aten::sort", 20, 30)]
    for name in QUERY_METRICS:
        assert _read(name, Reading(0, 1000, [("q18", 0, 1000)], [_kernel(0, 500)],
                                   sort_call, 1)) is None
        assert _read(name, None) is None
        assert _read(name, Reading(0, 1000, [], [_kernel(0, 500)], _query(0), 1)) is None


def test_the_bytes_are_the_referenced_columns_and_the_answer():
    config, traffic = _small()
    s = KIND.setup(config, traffic, SEED, core.Devices(["cpu"]))
    n_l, n_o, n_c = (int(next(iter(d.values())).shape[0]) for d in s.data)
    out = KIND.call(s, "q1")
    got = core.module("bytes", "q1").necessary_bytes(KIND.shapes(s, "q1", out))
    assert got == n_l * (8 * 4 + 1 + 1 + 4) + out.n_rows * (1 + 1 + 8 * 4 + 8 * 3 + 8)
    out = KIND.call(s, "q18")
    got = core.module("bytes", "q18").necessary_bytes(KIND.shapes(s, "q18", out))
    assert got == n_l * 16 + n_o * 28 + n_c * 12 + out.n_rows * (4 + 8 + 8 + 4 + 8 + 8)
