"""The port's measurement harnesses (``scripts/torch_*.py`` ports of
bench_suite, bench_single_algo, timings, capacity_study and bench_mesh) and
its consumer fixture against the JAX scripts, on the CPU at small sizes.

The JAX side runs in this process: its functions are imported from
``scripts/`` and run on the virtual 8-device CPU mesh of ``conftest.py``;
the port runs its plain versions on CPU tensors.  Both get the same numpy
inputs.  Where a JAX script's ``main`` is run for its metric names, the
call that times the device (``bench_injit``, the jitted sort, the shuffle)
is replaced by a stub: the names do not depend on it.
"""
import ast
import contextlib
import csv
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdst_tpu.engine as jengine
import rdst_tpu.parallel as jparallel
from rdst_tpu.ops.histogram import multi_level_histogram as jhist
from rdst_tpu.sorter import DEFAULT_THREADS as JTHREADS
from rdst_tpu.sorter import Sorter as JSorter
from rdst_tpu.tuner import TuningParams as JParams
from rdst_tpu_torch import _planes as P
from rdst_tpu_torch.ops.histogram import multi_level_histogram as thist
from rdst_tpu_torch.parallel import make_mesh, make_mesh_2d
from rdst_tpu_torch.sorter import Sorter as TSorter
from scripts import torch_bench_suite as tbs
from scripts import torch_capacity_study as tcs
from scripts import torch_timings as tt

# The JAX scripts put a repository root at the front of ``sys.path`` when
# imported (capacity_study.py a fixed one); ``scripts/`` is a namespace
# package, whose path follows ``sys.path``, so it is put back after them.
_saved_path = list(sys.path)
from scripts import bench_mesh as jbm  # noqa: E402
from scripts import bench_single_algo as jsa  # noqa: E402
from scripts import bench_suite as jbs  # noqa: E402
from scripts import timings as jt  # noqa: E402
from scripts import capacity_study as jcs  # noqa: E402  (last: it inserts a fixed root)

sys.path[:] = _saved_path

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 14
CONFIGS = tbs.make_configs(np.random.default_rng(0), N, set("12346"))


def _np(t):
    return P.sview(t).numpy().view(np.uint32) if t.dtype == torch.uint32 else t.numpy()


def _run(args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _rows(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _jax_main(module, argv, monkeypatch):
    """Run a JAX script's ``main`` with ``argv``; its standard output."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main()
    return buf.getvalue()


def test_scripts_come_from_this_checkout():
    """Every script module the tests use, and ``scripts/`` itself, lie
    under this checkout."""
    import scripts

    for mod in (tbs, tcs, tt, jbm, jsa, jbs, jcs, jt):
        assert os.path.abspath(mod.__file__).startswith(ROOT + os.sep), mod.__file__
    assert os.path.abspath(list(scripts.__path__)[0]) == os.path.join(ROOT, "scripts")


# -- scrambles, picks and one step of bench_suite ---------------------------


def test_scrambles_match_jax():
    rng = np.random.default_rng(3)
    ws = [rng.integers(0, 2**32, 1000, dtype=np.int64).astype(np.uint32) for _ in range(2)]
    tw = [torch.from_numpy(w) for w in ws]
    jw = [jnp.asarray(w) for w in ws]
    pairs = [(tbs.xor_scramble, jbs.xor_scramble)]
    pairs += [(tbs.suffix_scramble(s), jbs.suffix_scramble(s)) for s in (0, 1, 900, 1000)]
    for mine, theirs in pairs:
        got, want = mine(tw), theirs(jw)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint32
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert not np.array_equal(_np(tbs.xor_scramble(tw)[0]), ws[0])


@pytest.mark.parametrize("config", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_plan_pick_matches_jax(config):
    """bench_suite.py:157-166's pick (the JAX histogram and tuner) equals
    the port's on the same numpy words."""
    _, words, _, n_bytes, _, _ = config
    n = len(words[0])
    hist = jhist([jnp.asarray(w) for w in words], n_bytes)
    want = None
    if not hist.fully_sorted():
        params = JParams(threads=JTHREADS, level=n_bytes - 1, total_levels=n_bytes,
                         input_len=n)
        want = JSorter().tuner.pick_algorithm(
            params, hist.counts[n_bytes - 1].tolist()).value
    th = thist([torch.from_numpy(w) for w in words], n_bytes)
    got = tbs.plan_pick(TSorter(), th, n_bytes, n)
    assert (got and got.value) == want
    np.testing.assert_array_equal(th.counts, np.asarray(hist.counts))


STEPS = [c for c in CONFIGS if c[0] in (
    "c1_u32_10M_uniform", "c2_u64_payload_unstable_10M", "c2_u64_payload_stable_10M",
    "c3_struct_key_payload_10M")]


@pytest.mark.parametrize("config", STEPS, ids=[c[0] for c in STEPS])
def test_one_step_matches_jax(config):
    """One ``dispatcher_step``: keys bit-equal to the JAX harness's step;
    payloads bit-equal when stable, the same (key, payload) multiset when
    not.  The port's own check accepts its step."""
    metric, words, payloads, n_bytes, stable, _ = config
    nw = len(words)
    jin = tuple(jnp.asarray(w) for w in words + payloads)
    jstep = jbs.dispatcher_step(nw, n_bytes, stable, jhist(list(jin[:nw]), n_bytes),
                                JSorter(), jbs.xor_scramble)
    want = [np.asarray(x) for x in jstep(jin)]
    tin = tuple(torch.from_numpy(w) for w in words + payloads)
    tstep = tbs.dispatcher_step(nw, n_bytes, stable, thist(list(tin[:nw]), n_bytes),
                                TSorter(), tbs.xor_scramble)
    got = [_np(x) for x in tstep(tin)]
    for g, w in zip(got[:nw], want[:nw]):
        np.testing.assert_array_equal(g, w)
    if stable:
        for g, w in zip(got[nw:], want[nw:]):
            np.testing.assert_array_equal(g, w)
    else:
        def rows(planes):
            return sorted(zip(*[p.tolist() for p in planes]))

        assert rows(got) == rows(want)
    out = tstep(tin)
    tbs.check_sorted(metric, tbs.xor_scramble(list(tin[:nw])), list(tin[nw:]), n_bytes,
                     stable, list(out[:nw]), list(out[nw:]))


def test_check_sorted_rejects_a_wrong_sort():
    """The harness's check fails on a swapped pair of keys, and on a
    payload out of its stable place."""
    k = torch.tensor([5, 1, 3, 3], dtype=torch.int32).view(torch.uint32)
    v = torch.tensor([0, 1, 2, 3], dtype=torch.int32).view(torch.uint32)
    good_k = torch.tensor([1, 3, 3, 5], dtype=torch.int32).view(torch.uint32)
    tbs.check_sorted("ok", [k], [v], 4, True, [good_k],
                     [torch.tensor([1, 2, 3, 0], dtype=torch.int32).view(torch.uint32)])
    tbs.check_sorted("multiset", [k], [v], 4, False, [good_k],
                     [torch.tensor([1, 3, 2, 0], dtype=torch.int32).view(torch.uint32)])
    with pytest.raises(SystemExit):
        tbs.check_sorted("keys", [k], [], 4, False,
                         [torch.tensor([1, 3, 5, 3], dtype=torch.int32).view(torch.uint32)], [])
    with pytest.raises(SystemExit):
        tbs.check_sorted("stable", [k], [v], 4, True, [good_k],
                         [torch.tensor([1, 3, 2, 0], dtype=torch.int32).view(torch.uint32)])


def test_chained_only_where_the_histogram_stays_true():
    """A pick that reads bucket values (MtOop, a constant level under the
    compacted plans, a sorted input) runs unchained; the comparative plan
    and compacted plans without a constant level chain."""
    from rdst_tpu_torch.tuner import Algorithm

    rng = np.random.default_rng(5)
    varied = thist([torch.from_numpy(rng.integers(0, 2**32, 4096, dtype=np.int64)
                                     .astype(np.uint32))], 4)
    constant = thist([torch.from_numpy(rng.integers(0, 2**24, 4096, dtype=np.int64)
                                       .astype(np.uint32))], 4)
    assert not tbs.reads_absolute_counts(Algorithm.RECOMBINATING, varied)
    assert not tbs.reads_absolute_counts(Algorithm.COMPARATIVE, constant)
    assert tbs.reads_absolute_counts(Algorithm.LSB, constant)
    assert tbs.reads_absolute_counts(Algorithm.MT_OOP, varied)
    assert tbs.reads_absolute_counts(None, varied)


# -- capacity_study ---------------------------------------------------------

CAP_N = 1 << 12


@pytest.fixture(scope="module")
def cap_meshes():
    return (jcs.make_mesh(8), jcs.make_mesh_2d(2, 4),
            make_mesh(8, device="cpu"), make_mesh_2d(2, 4, device="cpu"))


def _cap_inputs(monkeypatch):
    monkeypatch.setattr(jcs, "N", CAP_N)
    theirs = jcs.distributions(np.random.default_rng(0xCAFE))
    ours = tcs.distributions(np.random.default_rng(0xCAFE), CAP_N)
    return theirs, ours


@pytest.mark.parametrize("name", ["uniform", "bimodal_s32", "zipf_1.2", "low_entropy_16b",
                                  "sorted_uniform", "all_equal", "hot_multikey_88pct"])
def test_capacity_demand_matches_jax(name, cap_meshes, monkeypatch):
    j1, j2, t1, t2 = cap_meshes
    theirs, ours = _cap_inputs(monkeypatch)
    np.testing.assert_array_equal(ours[name], theirs[name])
    x = theirs[name]
    assert tcs.demand_ratio(x, t1, "shard") == jcs.demand_ratio(x, j1, "shard")
    assert (tcs.demand_ratio(x, t2, t2.axis_names)
            == jcs.demand_ratio(x, j2, j2.axis_names))


@pytest.mark.parametrize("name", ["uniform", "hot_multikey_88pct"])
def test_stage1_headroom_matches_jax(name, cap_meshes, monkeypatch):
    _, j2, _, t2 = cap_meshes
    theirs, _ = _cap_inputs(monkeypatch)
    x = theirs[name]
    f = max(1.25, 1.1 * jcs.demand_ratio(x, j2, j2.axis_names))
    from rdst_tpu_torch import config

    before = config.hier_stage1_headroom
    got = tcs.stage1_headroom_needed(x, t2, f)
    assert got == jcs.stage1_headroom_needed(x, j2, f)
    assert config.hier_stage1_headroom == before
    if name == "hot_multikey_88pct":
        assert got > 1.0  # the search does move past an overflow


def test_two_hot_keys_demand_matches_jax_at_2_20(cap_meshes):
    """At 2^20 keys each hot key lands whole on one shard (demand 3.52) in
    the JAX package's shuffle and in the port's alike; below 2^20 both
    split them (demand 1.0)."""
    j1, _, t1, _ = cap_meshes
    x = tcs.distributions(np.random.default_rng(0xCAFE), 1 << 20)["two_hot_keys_44pct_each"]
    got = tcs.demand_ratio(x, t1, "shard")
    assert got == jcs.demand_ratio(x, j1, "shard")
    assert got > 3.5


def test_two_hot_keys_fall_in_different_shards():
    x = tcs.distributions(np.random.default_rng(0xCAFE), CAP_N)["two_hot_keys_44pct_each"]
    keys, counts = np.unique(x, return_counts=True)
    hot = keys[counts >= 0.4 * CAP_N]
    assert len(hot) == 2 and all(c >= 0.43 * CAP_N for c in counts[counts >= 0.4 * CAP_N])
    # their positions in the sorted order lie in different eighths
    s = np.sort(x)
    first = [int(np.searchsorted(s, k)) * 8 // CAP_N for k in hot]
    assert first[0] != first[1]


# -- timings ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint32", "uint64", "uint128"])
def test_timings_sizes_hold_both_bimodal_halves(dtype):
    """Every size of a bimodal pool, cut as the port cuts it (centred),
    holds both halves; the reference's prefix cut (timings.py:96) holds
    only the ``>>`` half at every size up to half the pool."""
    n = 1 << 12
    rng = np.random.default_rng(0)
    if dtype == "uint128":
        hi, lo = tt.gen_u128(rng, n, "bimodal")
        small, big = hi == 0, lo == 0  # hi moved into lo / lo moved into hi
        assert np.array_equal((hi, lo), jt.gen_u128(np.random.default_rng(0), n, "bimodal"))
    else:
        x = tt.gen(rng, n, np.dtype(dtype), "bimodal")
        np.testing.assert_array_equal(x, jt.gen(np.random.default_rng(0), n, np.dtype(dtype),
                                                "bimodal"))
        half = np.dtype(dtype).itemsize * 4
        low = x.dtype.type((1 << half) - 1)
        small = (x >> x.dtype.type(half)) == 0
        big = ((x & low) == 0) & (x != 0)
    size = n
    while size >= 16:
        part_s, part_b = tt.centred(small, size), tt.centred(big, size)
        assert part_s.any() and part_b.any(), size
        if size <= n // 2:
            assert not big[:size].any()  # the reference's prefix slice
        size //= 2


# -- the scripts end to end, and their names --------------------------------


def _jax_suite_names(configs):
    """The metric names bench_suite.py's main can print for ``--configs``:
    the literal first argument of each ``bench_config`` call under each
    ``if "<config>" in run``."""
    tree = ast.parse(open(jbs.__file__).read())
    names = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and isinstance(node.test.left, ast.Constant)
                and node.test.left.value in configs):
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call) and getattr(sub.func, "id", "") == "bench_config"):
                    names.append(sub.args[0].value)
    return names


def test_bench_suite_script(monkeypatch):
    rows = _rows(_run(["scripts/torch_bench_suite.py", "--device", "cpu", "--n", "8192",
                       "--iters", "2"]))
    assert [r["metric"] for r in rows] == _jax_suite_names("12346")
    assert len(rows) == 8
    for r in rows:
        assert {"metric", "value", "unit", "vs_baseline", "plan"} <= set(r)
        assert r["mode"] == "chained" and r["n"] == 8192 or "409k" in r["metric"]
    rows = _rows(_run(["scripts/torch_bench_suite.py", "--device", "cpu", "--n", "4096",
                       "--iters", "1", "--configs", "3,4"]))
    assert [r["metric"] for r in rows] == _jax_suite_names("34")


def test_bench_single_algo_script(monkeypatch):
    args = ["--n", "512", "--tuners"]
    ours = _rows(_run(["scripts/torch_bench_single_algo.py", "--device", "cpu", "--iters",
                       "1", *args]))
    monkeypatch.setattr(jbs, "bench_injit", lambda step, a, iters=None: 1.0)
    theirs = _rows(_jax_main(jsa, args, monkeypatch))
    assert [r["metric"] for r in ours] == [r["metric"] for r in theirs]
    assert len(ours) == 21
    assert all(set(r) == set(t) for r, t in zip(ours, theirs))
    modes = {r["metric"]: r["mode"] for r in ours}
    assert {m for m, v in modes.items() if v == "unchained"} == {
        "single_algo_mt_oop_u32_512", "single_algo_mt_oop_u64_512"}


def test_timings_script(tmp_path, monkeypatch):
    args = ["--min-exp", "8", "--max-exp", "9", "--reps", "1"]
    out = _run(["scripts/torch_timings.py", "--device", "cpu", "--out",
                str(tmp_path / "ours.csv"), *args])
    monkeypatch.setattr(jengine, "sort_words", lambda ws: (ws, []))
    _jax_main(jt, ["--out", str(tmp_path / "theirs.csv"), *args], monkeypatch)
    ours = list(csv.DictReader(open(tmp_path / "ours.csv")))
    theirs = list(csv.DictReader(open(tmp_path / "theirs.csv")))
    assert list(ours[0]) == list(theirs[0]) + ["device"]
    key = ("type", "dist", "n")
    assert [[r[k] for k in key] for r in ours] == [[r[k] for k in key] for r in theirs]
    assert all(r["device"] == "cpu" and float(r["seconds"]) > 0 for r in ours)
    medleys = [line for line in out.splitlines() if line.startswith("medley ")]
    assert [m.split(":")[0] for m in medleys] == [
        f"medley {t} {d}" for t in tt.TYPES for d in tt.DISTS]


def test_capacity_study_script():
    out = _run(["scripts/torch_capacity_study.py", "--device", "cpu", "--n", "2048"])
    table = [line.split("|")[1].strip() for line in out.splitlines()
             if line.startswith("| ") and "distribution" not in line]
    names = list(jcs.distributions(np.random.default_rng(0xCAFE)))
    assert table == names + ["two_hot_keys_44pct_each"]


def test_bench_mesh_script(monkeypatch):
    args = ["--per-device", "256", "--iters", "1"]
    ours = _rows(_run(["scripts/torch_bench_mesh.py", "--device", "cpu", *args]))

    def stub(words, payloads, *, mesh, axis="shard", **_):
        return words, payloads, jnp.zeros(mesh.size, jnp.int32)

    monkeypatch.setattr(jparallel, "distributed_sort", stub)
    theirs = _rows(_jax_main(jbm, args, monkeypatch))
    assert [r["metric"] for r in ours] == [r["metric"] for r in theirs]
    assert [r["metric"] for r in ours] == [
        "dist_shuffle_rows_per_s_D1", "dist_shuffle_rows_per_s_D2",
        "dist_shuffle_rows_per_s_D4", "dist_shuffle_rows_per_s_D8",
        "dist_shuffle_rows_per_s_hier_2x4"]
    assert all(set(r) == set(t) for r, t in zip(ours, theirs))


@pytest.mark.parametrize("cards", [2, 4])
def test_bench_mesh_script_on_cards(cards):
    """``--cards K``: each mesh over min(D, K) card entries (the reference's
    one device a shard), the same rows as on one device, each checked."""
    args = ["--device", "cpu", "--per-device", "256", "--iters", "1"]
    one = _rows(_run(["scripts/torch_bench_mesh.py", *args]))
    many = _rows(_run(["scripts/torch_bench_mesh.py", *args, "--cards", str(cards)]))
    assert [r["metric"] for r in many] == [r["metric"] for r in one]
    assert all(set(r) == set(t) and r["devices"] == t["devices"] and r["value"] > 0
               for r, t in zip(many, one))


def test_consumer_fixture():
    out = _run(["fixtures/torch_consumer.py", "--device", "cpu"])
    assert out.strip().splitlines()[-1] == "consumer smoke: OK"


SCRIPTS = ["scripts/torch_bench_suite.py", "scripts/torch_bench_single_algo.py",
           "scripts/torch_timings.py", "scripts/torch_capacity_study.py",
           "scripts/torch_bench_mesh.py", "fixtures/torch_consumer.py",
           "scripts/torch_acceptance.py", "scripts/torch_floor_table.py"]


@pytest.fixture(scope="module")
def default_runs():
    """Each script run with no arguments, all started together.  Where CUDA
    is present they would run on the card at full size, so nothing starts."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default runs on the card")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {s: subprocess.Popen([sys.executable, s], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
             for s in SCRIPTS}
    out = {}
    try:
        for s, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[s] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_refuse_cuda_without_a_card(script, default_runs):
    """``--device`` defaults to the card; without CUDA the script raises
    rather than fall back to the CPU."""
    rc, stdout, stderr = default_runs[script]
    assert rc != 0 and "CUDA is not available" in stderr
    assert not _rows(stdout)
