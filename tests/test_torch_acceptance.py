"""The port's acceptance suite and floor table (``scripts/torch_acceptance.py``,
``scripts/torch_floor_table.py``) on the CPU at small sizes, against the JAX
scripts they port (``scripts/tpu_acceptance.py``, ``scripts/floor_table.py``).

The JAX scripts are read, not run: the acceptance check names come from the
source of ``tpu_acceptance.py``, and ``floor_table.vpu_bound_ns`` is a
computation on ints and floats.  The port's scripts run their kernels'
plain versions on CPU tensors, with the fused executor's size gates lowered
so that the dispatcher reaches it.
"""
import ast
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from rdst_tpu_torch import _build
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch import config
from rdst_tpu_torch.ops import fused_sort as fs
from rdst_tpu_torch.ops import radix_sort as rs
from scripts import torch_acceptance as ta
from scripts import torch_bench_suite as tbs
from scripts import torch_floor_table as tf

_saved_path = list(sys.path)
from scripts import floor_table as jft  # noqa: E402  (it puts a root on sys.path)

sys.path[:] = _saved_path

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 2^12-2^14 rows; lengths off a power of two take the piece path
SMALL = {"u32_50m": 12_500, "u32_20m": 10_000, "u64_20m": 10_000, "zipf": 7_000,
         "pow2": 1 << 12, "struct": 5_000, "lowmem": 10_000, "big": 1 << 14,
         "dist": 1 << 12}


def _reference_names():
    """The names of ``check(...)`` in tpu_acceptance.py, in source order; an
    f-string's text before its first value, less the " (" that opens the
    time it prints."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "tpu_acceptance.py")).read())
    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", "") == "check"), key=lambda c: c.lineno)
    names = []
    for c in calls:
        a = c.args[0]
        if isinstance(a, ast.Constant):
            names.append(a.value)
            continue
        head = []
        for v in a.values:
            if not isinstance(v, ast.Constant):
                break
            head.append(v.value)
        names.append("".join(head).removesuffix(" ("))
    return names


@pytest.fixture
def small(monkeypatch):
    """The acceptance sizes cut to ``SMALL``, and the fused executor's gates
    lowered so that those sizes reach B2/B3's plain versions."""
    for k, v in SMALL.items():
        monkeypatch.setitem(ta.SIZES, k, v)
    monkeypatch.setattr(config, "fused_min_elems", 1 << 12)
    monkeypatch.setattr(config, "fused_min_piece", 1 << 11)


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ta.main(argv)
    return rc, buf.getvalue().splitlines()


def test_check_names_follow_the_reference():
    """The port's checks are tpu_acceptance.py's, in its order: the names in
    the port's source equal the reference's."""
    want = _reference_names()
    assert len(want) == 11
    tree = ast.parse(open(ta.__file__).read())
    got = [c.args[0].value for c in sorted(
        (n for n in ast.walk(tree) if isinstance(n, ast.Call)
         and getattr(n.func, "id", "") == "check"), key=lambda c: c.lineno)]
    assert got == want


def test_main_on_the_cpu_passes_every_check(small, tmp_path):
    # the low-memory tuner picks Regions (B4/B5) above 1M rows only: the
    # card's run must launch them (chip_smoke.ACCEPTANCE_RUNS)
    kernels = ("radix_pass",)  # the checks' keys have at most 64 bits
    before = {k: _build.KERNELS[k].plain_calls for k in kernels}
    out_json = tmp_path / "accept.json"
    rc, lines = _main(["--device", "cpu", "--json", str(out_json)])
    assert rc == 0 and lines[-1] == "ALL OK"
    names = _reference_names()
    assert [line.rsplit(" (", 1)[0] for line in lines[:-1]] == [f"PASS {n}" for n in names]
    rec = json.loads(out_json.read_text())
    assert rec["device"] == "cpu" and rec["all_ok"] is True
    assert [c["check"] for c in rec["checks"]] == names
    assert all(c["ok"] and c["seconds"] > 0 for c in rec["checks"])
    # the fused executor ran (plain versions)
    assert all(_build.KERNELS[k].plain_calls > before[k] for k in kernels)


def test_a_wrong_sort_fails_its_checks_and_exits_1(small, monkeypatch):
    real = ta.rt.radix_sort_unstable

    def reversed_sort(x, **kw):
        return real(x, **kw)[::-1].copy()

    monkeypatch.setattr(ta.rt, "radix_sort_unstable", reversed_sort)
    rc, lines = _main(["--device", "cpu"])
    assert rc == 1 and lines[-1] == "FAILURES PRESENT"
    failed = [line.rsplit(" (", 1)[0][5:] for line in lines if line.startswith("FAIL ")]
    assert failed == ["u32 50M default pipeline", "u64 50M default pipeline",
                      "u32 20M default/tuner pipeline", "f64 20M with NaN/Inf",
                      "zipf 10M tuner path", "u64 2^27 (134M) default pipeline e2e"]


def test_the_forced_gate_is_restored_when_the_check_raises(small, monkeypatch):
    real = ta.rt.radix_sort_builder
    seen = []

    class Raising:
        def sort(self):
            seen.append(config.low_mem_threshold_bytes)
            raise RuntimeError("stub")

    def builder(*a, **kw):
        b = real(*a, **kw)
        b.with_low_mem_tuner = lambda: Raising()
        return b

    monkeypatch.setattr(ta.rt, "radix_sort_builder", builder)
    gate = config.low_mem_threshold_bytes
    with pytest.raises(RuntimeError, match="stub"), contextlib.redirect_stdout(io.StringIO()):
        ta.main(["--device", "cpu"])
    assert seen == [1] and config.low_mem_threshold_bytes == gate


@pytest.mark.parametrize("n", [2000, 1 << 12, 5_000, 950_000, 1 << 20, 1_000_000,
                               3_000_000, 10_000_000, 1 << 25, 50_000_000, 1 << 27])
def test_stage_count_is_the_reference_bound_per_stage(n):
    """floor_table.vpu_bound_ns(n, P) is stage_count(n) times its cost per
    stage, over both branches: below 2^12, powers of two and lengths within
    1.13 of one, and the piece decomposition."""
    for planes in (2, 3, 4, 5):
        c = 0.0065 + 0.0032 * (planes - 2)
        assert tf.stage_count(n) * c == jft.vpu_bound_ns(n, planes)


def _planes_of(spec, n, rng):
    _, _, dtypes, _, _ = spec
    out = []
    for dt in dtypes:
        top = 2**16 if dt == np.uint16 else 2**32
        out.append(torch.from_numpy(rng.integers(0, top, n).astype(dt)))
    return out


@pytest.mark.parametrize("spec", tf.SHAPES, ids=[s[0] for s in tf.SHAPES])
def test_torch_raw_step_computes_the_fused_step(spec):
    """The library column sorts what the fused column sorts: at 2^12 with
    duplicate keys, keys bit-equal, payloads bit-equal when stable, else the
    same (key, payload) multiset."""
    label, _, dtypes, n_pay, stable = spec
    rng = np.random.default_rng(11)
    planes = _planes_of(spec, 1 << 12, rng)
    for p in planes[:len(planes) - n_pay]:  # ties in every key
        p.copy_(P.narrow(P.widen(p) & 0x3F, p.dtype))
    k = len(planes) - n_pay
    fused = tf.fused_step(k, stable)(planes)
    lib = tf.torch_step(k, stable)(planes)
    assert [p.dtype for p in lib] == [p.dtype for p in fused] == [p.dtype for p in planes]
    for a, b in zip(fused[:k], lib[:k]):
        assert torch.equal(P.sview(a), P.sview(b))
    if stable or not n_pay:
        for a, b in zip(fused, lib):
            assert torch.equal(P.sview(a), P.sview(b))
    else:
        def rows(out):
            cols = [P.widen(p) for p in out]
            order = tbs.lex_order(cols)
            return [c[order] for c in cols]
        for a, b in zip(rows(fused), rows(lib)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("spec,want", zip(tf.SHAPES, [
    536_870_912, 80_000_000, 240_000_000, 320_000_000, 280_000_000]),
    ids=[s[0] for s in tf.SHAPES])
def test_bound_counts_each_plane_once_each_way(spec, want):
    """The bound's bytes at the full sizes: every plane read and written
    once, with a stable sort's u32 index plane."""
    _, size, dtypes, _, stable = spec
    planes = [torch.empty(tf.SIZES[size], dtype=torch.from_numpy(np.zeros(0, dt)).dtype,
                          device="meta") for dt in dtypes]
    assert tf.bound_bytes(planes, stable) == want


def _fs_fns():
    return (fs.tail_call, fs.span_call, fs.P.lex_sort, fs.piece_merge,
            rs.radix_pass, rs.radix_pass_plain)


def test_executor_trips_count_the_launches(monkeypatch):
    """The trips counted for the executor floor are the launches the fused
    sort makes (the wrappers' plain calls on the CPU), and the wrappers are
    put back after: the floor table's shapes take the radix passes, one B8
    trip a key byte; with a second payload plane the same rows take the
    network."""
    monkeypatch.setattr(config, "fused_min_piece", 1 << 11)
    rng = np.random.default_rng(3)
    for n in (1 << 13, 10_000):
        planes = _planes_of(tf.SHAPES[3], n, rng)
        real = _fs_fns()
        before = _build.KERNELS["radix_pass"].plain_calls
        trips = tf.executor_trips(planes, 2, True)
        assert _fs_fns() == real
        assert trips == {"B8": (8, 8 * 2 * n * 12)}
        assert _build.KERNELS["radix_pass"].plain_calls - before == 8
    for n in (1 << 13, 10_000):  # the power-of-two core, the piece path
        planes = _planes_of(tf.SHAPES[3], n, rng)
        planes.append(P.flip(planes[-1]))
        kinds = ("bitonic_tail", "bitonic_span", "piece_merge")
        before = {k: _build.KERNELS[k].plain_calls for k in kinds}
        trips = tf.executor_trips(planes, 2, True)
        assert _fs_fns() == real
        assert trips["B2"][0] == _build.KERNELS["bitonic_tail"].plain_calls - before["bitonic_tail"]
        assert trips.get("B3", (0, 0))[0] == (
            _build.KERNELS["bitonic_span"].plain_calls - before["bitonic_span"])
        assert trips.get("merge", (0, 0))[0] == (
            _build.KERNELS["piece_merge"].plain_calls - before["piece_merge"])
        assert trips["phase 0"][0] >= 1
        assert ("merge" in trips) == (n == 10_000)
        if n == 10_000:  # pieces of 8 and 2 x 1024 rows: one merge, 20 bytes a row
            assert trips["merge"] == (1, 2 * 10_240 * 20)
        # a stable sort's trips carry the index plane: 20 bytes a row
        b2_calls, b2_bytes = trips["B2"]
        assert b2_bytes % (2 * 20) == 0 and b2_bytes >= b2_calls * 2 * 20 * 2048


def test_floor_table_prints_five_rows_on_the_cpu(monkeypatch):
    monkeypatch.setitem(tf.SIZES, "headline", 1 << 12)
    monkeypatch.setitem(tf.SIZES, "n10", 10_000)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tf.main(["--device", "cpu", "--iters", "1"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0] == "device: cpu"
    rows = [line.split(" | ") for line in lines[3:]]
    assert [r[0][2:] for r in rows] == [s[0] for s in tf.SHAPES]
    for r, shape in zip(rows, tf.SHAPES):
        # every shape has at most 8 key bytes and one payload: one B8 trip
        # a key byte
        key_bytes = sum(np.dtype(dt).itemsize for dt in shape[2][:len(shape[2]) - shape[3]])
        assert all(float(v) > 0 for v in r[1:8]) and r[-1].rstrip(" |") == f"B8 {key_bytes}"


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
def test_scramble_cuts_the_constant_to_each_width(dtype):
    """floor_table.py XORs each plane with 0xB5A93E6B cut to its width."""
    x = np.random.default_rng(5).integers(0, np.iinfo(dtype).max, 1000).astype(dtype)
    got = tbs.xor_scramble([torch.from_numpy(x)])[0]
    want = x ^ dtype(0xB5A93E6B & np.iinfo(dtype).max)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(P.sview(got).numpy().view(dtype), want)
