"""The harness finds a configuration, a cell, a traffic mix and a metric
by their files alone: a copy of the benchmark with files added, and
nothing edited, runs a new cell and reports a new metric."""
import json
import shutil
from pathlib import Path

import bench_core as core
import bench_testing

HERE = Path(__file__).resolve().parent


def test_added_files_make_a_cell_and_a_metric(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}

    cfg = json.loads((root / "configs" / "rdst_full_sort_u64_50m.json").read_text())
    cfg.update(name="rdst_full_sort_u64_2m", n_keys=1 << 21)
    (root / "configs" / "rdst_full_sort_u64_2m.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "closed_tensor_pool4.json").read_text())
    traffic.update(pool=2, trace_calls=2)
    (root / "traffic" / "closed_tensor_pool2.json").write_text(json.dumps(traffic))
    (root / "workloads" / "sort_u64_2m_tensor.json").write_text(json.dumps(
        {"name": "sort_u64_2m_tensor", "config": "rdst_full_sort_u64_2m",
         "traffic": "closed_tensor_pool2", "chips": 1, "why": "a test's cell"}))
    (root / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return float(len(run.spans))\n")

    res = bench_testing.run_small("sort_u64_2m_tensor", root=root, n_keys=1 << 12)
    assert res["correct"]
    manifest = {"end_to_end": [{"name": "rows_per_s", "unit": "rows/s"}],
                "per_layer": [{"name": "calls_in_window", "unit": "calls",
                               "moves": "rows_per_s",
                               "workloads": ["sort_u64_2m_tensor"]}]}
    metrics = core.reported(manifest, "sort_u64_2m_tensor", "per_layer")
    values = core.metric_values(res["run"], metrics, root)
    assert values["calls_in_window"]["value"] == len(res["run"].spans) > 0
    assert core.reported(manifest, "another_cell", "per_layer") == []

    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_a_metric_without_cells_follows_the_end_to_end_metric_it_moves():
    manifest = {"end_to_end": [{"name": "rows_per_s"},
                               {"name": "call_p95_ms", "workloads": ["a"]}],
                "per_layer": [{"name": "x", "moves": "call_p95_ms"},
                              {"name": "y", "moves": "rows_per_s"}]}
    assert [m["name"] for m in core.reported(manifest, "a", "per_layer")] == ["x", "y"]
    assert [m["name"] for m in core.reported(manifest, "b", "per_layer")] == ["y"]
    assert [m["name"] for m in core.reported(manifest, "b", "end_to_end")] == ["rows_per_s"]
