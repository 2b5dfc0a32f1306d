"""``BENCHMARK.json`` against the benchmark's contract and its own files:
names, units and lengths; each metric's ``moves`` and cells; every file a
name leads to; and the imports that the benchmark may not make."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import bench_core as core

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"[^\t\n\r]{1,200}$")
E2E = {m["name"] for m in MANIFEST["end_to_end"]}


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert TEXT.match(w["why"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in MANIFEST["per_layer"]:
        assert TEXT.match(m["layer"])
    for word in MANIFEST["command"]:
        assert TEXT.match(word)


@pytest.mark.parametrize("section,keys,optional", [
    ("configs", {"name", "source", "file", "reduced", "why"}, set()),
    ("workloads", {"name", "config", "traffic", "chips", "why"}, set()),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}, {"workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
])
def test_entry_keys(section, keys, optional):
    for e in MANIFEST[section]:
        assert keys <= set(e) <= keys | optional, e


def test_bounds_and_sources():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_each_moves_names_an_end_to_end_metric_its_cells_report():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in E2E
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in core.reported(MANIFEST, cell, "end_to_end")}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MANIFEST["workloads"]:
        e2e = {m["name"] for m in core.reported(MANIFEST, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.reported(MANIFEST, w["name"], "per_layer")


def test_layers_share_one_name_per_layer():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    prefixes = [layer.split(":")[0] for layer in layers]
    assert len(prefixes) == len(set(prefixes))


def test_cells_configs_and_their_files_agree():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    four = 0
    for w in MANIFEST["workloads"]:
        f = core.cell_file(w["name"])
        assert {k: f[k] for k in ("name", "config", "traffic", "chips", "why")} == w
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        cfg = configs[w["config"]]
        used.add(cfg["name"])
        assert (ROOT / cfg["file"]).is_file()
        assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
        data = core.config_file(cfg["name"])
        assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
        assert all(k in data for k in data["reduced"])
        traffic = core.traffic_file(w["traffic"])
        kind = core.module("traffic", traffic["kind"])
        assert (HERE / "reference" / f"{traffic['kind']}.py").is_file()
        for op in kind.OPS:
            assert (HERE / "bytes" / f"{op}.py").is_file()
    assert used == set(configs)
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_metric_has_a_reader():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(core.module("metrics", m["name"]).read)


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel) and len(rel) <= 200, rel


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program_or_jax(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & {"rdst_tpu_torch", "rdst_tpu", "jax", "jaxlib"}, tops


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax_chip_smoke_or_scripts(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & {"rdst_tpu", "jax", "jaxlib", "flax", "chip_smoke", "scripts"}, tops


def test_the_reference_loads_no_program_module():
    code = ("import sys, importlib.util\n"
            f"for name in ('sort_calls',):\n"
            f"    p = {str(HERE / 'reference')!r} + '/' + name + '.py'\n"
            "    s = importlib.util.spec_from_file_location(name, p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('rdst_tpu_torch', 'rdst_tpu', 'jax', 'jaxlib')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert out.strip() == "[]"


def test_forbidden_names_are_compared_whole():
    assert core.forbidden_modules(["rdst_tpu_torch", "rdst_tpu_torch.parallel", "numpy"]) == []
    assert core.forbidden_modules(["rdst_tpu.ops", "jax", "jaxlib.xla", "jaxtyping"]) == [
        "jax", "jaxlib.xla", "rdst_tpu.ops"]


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "sort_u64_50m_tensor", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    if "needs 1 CUDA card" not in proc.stderr:
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
