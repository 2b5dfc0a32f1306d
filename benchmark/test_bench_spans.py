"""The readers of the program's spans (``bench_spans``) on hand-built
readings, and on a traced CPU run of each cell."""
import pytest

import bench_core as core
import bench_spans
import bench_testing
from bench_trace import DeviceOp, Reading

SPAN_METRICS = ("api_host_ms_per_call", "host_syncs_per_call", "idle_ms_per_call.api",
                "idle_ms_per_call.plans", "idle_ms_per_call.executor")
IDLE = ("idle_ms_per_call.api", "idle_ms_per_call.plans", "idle_ms_per_call.executor")


def _run(reading):
    return core.Run("cell", {}, {}, [], 1.0, 1.0, [0], {}, reading)


def _read(name, reading):
    return core.module("metrics", name).read(_run(reading))


def _kernel(a, b, device=0):
    return DeviceOp("k", "kernel", device, a, b)


def _call(t0):
    """One call's spans from t0 (ns), nested as the program records them,
    and torch's own events inside, which the readers pass over."""
    return [
        ("rdst.sort", t0, t0 + 1000),
        ("rdst.keys.normalize", t0 + 10, t0 + 90),
        ("rdst.sorter.run", t0 + 100, t0 + 900),
        ("rdst.histogram", t0 + 110, t0 + 200),
        ("rdst.sync.histogram", t0 + 150, t0 + 200),
        ("aten::copy_", t0 + 151, t0 + 199),
        ("rdst.plan.Recombinating", t0 + 220, t0 + 890),
        ("rdst.fused_sort", t0 + 230, t0 + 880),
        ("rdst.fused_sort.network", t0 + 300, t0 + 800),
        ("cudaLaunchKernel", t0 + 400, t0 + 410),
        ("rdst.keys.denormalize", t0 + 910, t0 + 990),
    ]


def _reading(host, kernels, ops=(("sort", 0, 1000),), n_cards=1, end=1200):
    return Reading(0, end, list(ops), kernels, list(host), n_cards)


def test_a_gap_goes_to_the_innermost_span_that_is_not_a_sync():
    # busy everywhere but four gaps: in normalize (api), in the histogram's
    # readback (plans, not sync), in the network (executor, not the launch
    # under it), and after the call (no layer)
    gaps = [(40, 60), (160, 190), (395, 415), (1050, 1150)]
    busy, t = [], 0
    for a, b in gaps:
        busy.append(_kernel(t, a))
        t = b
    busy.append(_kernel(t, 1200))
    r = _reading(_call(0), busy)
    assert bench_spans.idle_ns_by_layer(r) == {"api": 20, "plans": 30, "executor": 20}
    assert _read("idle_ms_per_call.api", r) == pytest.approx(20e-6)
    assert _read("idle_ms_per_call.plans", r) == pytest.approx(30e-6)
    assert _read("idle_ms_per_call.executor", r) == pytest.approx(20e-6)


@pytest.mark.parametrize("n_cards", [1, 2])
def test_the_idle_metrics_sum_to_no_more_than_the_stretch_idle(n_cards):
    host = _call(0) + _call(1500)
    ops = [("sort", 0, 1000), ("sort", 1500, 2500)]
    kernels = [_kernel(0, 30), _kernel(250, 300), _kernel(1490, 1700), _kernel(2000, 2600)]
    if n_cards == 2:
        kernels.append(_kernel(100, 2000, device=1))
    r = _reading(host, kernels, ops, n_cards, end=2800)
    total = sum(_read(m, r) for m in IDLE)
    idle_ms = sum(b - a for d in r.devices() for a, b in r.gaps(d)) / 1e6 / n_cards / r.calls()
    assert 0 < total <= idle_ms


def test_api_host_time_leaves_out_the_sorter():
    r = _reading(_call(0) + _call(2000), [_kernel(0, 3000)],
                 [("sort", 0, 1000), ("sort", 2000, 3000)], end=3000)
    assert _read("api_host_ms_per_call", r) == pytest.approx((1000 - 800) / 1e6)


def test_host_syncs_count_the_sync_spans():
    host = _call(0) + [("rdst.sync.to_numpy", 950, 980)]
    assert _read("host_syncs_per_call", _reading(host, [_kernel(0, 1200)])) == 2


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_every_reader_returns_none_without_program_spans(name):
    torch_only = [(n, s, e) for n, s, e in _call(0) if not n.startswith("rdst.")]
    assert _read(name, _reading(torch_only, [_kernel(0, 500)])) is None
    assert _read(name, None) is None
    assert _read(name, _reading(_call(0), [_kernel(0, 500)], ops=())) is None


@pytest.mark.parametrize("cell,syncs", [("sort_u64_50m_tensor", 1), ("sort_u64_50m_numpy", 2)])
def test_a_traced_cpu_run_reads_the_spans(cell, syncs):
    """The cell's calls through ``bench_trace``'s reading: every call's
    spans are there (2^14 keys: no fused executor on the CPU)."""
    res = bench_testing.run_small(cell, trace=True)
    run = res["run"]
    assert res["correct"]
    assert core.module("metrics", "host_syncs_per_call").read(run) == syncs
    assert 0 < core.module("metrics", "api_host_ms_per_call").read(run)
    names = {n for n, _, _ in bench_spans.spans(run.profile)}
    assert {"rdst.sort", "rdst.sorter.run", "rdst.histogram", "rdst.tuner.pick"} <= names
    manifest = core.load_json(core.HERE.parent / "BENCHMARK.json")
    metrics = core.reported(manifest, cell, "per_layer")
    values = core.metric_values(run, metrics)
    assert {m["name"] for m in metrics if m["source"] == "program_span"} <= set(values)
