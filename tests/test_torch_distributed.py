"""The port's shuffle over processes (``init_distributed`` and a mesh over
the default process group) against its one-process mesh and the JAX
package's virtual 8-device mesh.

Each world size (2 and 4) starts its ranks once, as fresh processes running
this file (:func:`_child`), with gloo on the CPU and a ``file://``
rendezvous in a temporary directory of its own.  Every rank runs every case
of ``CASES`` on its own rows (``8 // world`` shards of ``N_LOCAL`` rows) and
writes its planes, the counts and ``gather_valid(..., mesh=mesh)`` with
``np.save``.  The parent reassembles the planes rank-major and holds them
bit-equal, every plane and the counts, to the port's one-process mesh of the
same shape, and to the JAX package by ``test_torch_shuffle.py``'s rules.
Each child runs under its own time limit and is killed past it; the test
then fails with its stderr.  The children import neither JAX nor
``rdst_tpu``.
"""
import inspect
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rdst_tpu_torch import config
from rdst_tpu_torch import parallel as tp
from rdst_tpu_torch.parallel import mesh as tmesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_LOCAL = 1 << 12  # rows a shard
D = 8
N = D * N_LOCAL
CHILD_SECONDS = 240

# name: (mesh shape, input, entry, keyword arguments, config overrides)
CASES = {
    "flat_u64_stable": ((8,), "u64", "sort", dict(stable=True), {}),
    "flat_u32_unstable": ((8,), "u32", "sort", dict(), {}),
    "flat_overlap_stable": ((8,), "u64", "sort",
                            dict(stable=True, overlap_exchange=True), {}),
    "flat_overlap_unstable": ((8,), "hot_key", "sort",
                              dict(overlap_exchange=True), {}),
    "hot_key_unstable": ((8,), "hot_key", "sort", dict(), {}),
    "hot_key_stable": ((8,), "hot_key", "sort", dict(stable=True), {}),
    "hot_bucket_refined": ((8,), "hot_bucket", "sort",
                           dict(stable=True, capacity_factor=8.0), {}),
    "mesh2d_2x4_stable": ((2, 4), "u64", "sort", dict(stable=True), {}),
    "mesh2d_2x4_overlap": ((2, 4), "u64", "sort",
                           dict(stable=True, overlap_exchange=True), {}),
    "mesh2d_4x2_unstable": ((4, 2), "u32", "sort", dict(), {}),
    "mesh2d_4x2_overlap": ((4, 2), "hot_key", "sort",
                           dict(stable=True, overlap_exchange=True), {}),
    "stage1_overflow": ((2, 4), "funnel", "sort", dict(capacity_factor=1.3),
                        {"hier_stage1_headroom": 1.0}),
    "auto_retry": ((8,), "deep_hot", "auto",
                   dict(stable=True, capacity_factor=1.1), {}),
    "partition_exchange": ((8,), "fact", "partition",
                           dict(stable=True, capacity_factor=3.0), {}),
}


def _u64_planes(x):
    return [(x >> np.uint64(32)).astype(np.uint32),
            (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)]


def _inputs(name):
    """(key words, payloads) of ``N`` rows; the inputs of
    ``test_torch_shuffle.py`` and ``test_overflow.py`` at this size."""
    rng = np.random.default_rng(sum(map(ord, name)))
    pay = [np.arange(N, dtype=np.uint32)]
    if name == "u64":
        return _u64_planes(rng.integers(0, 2**64, size=N, dtype=np.uint64)), pay
    if name == "u32":
        return [rng.integers(0, 2**32, size=N, dtype=np.uint32)], pay
    if name == "hot_key":  # one key on 75% of the rows
        x = np.concatenate([np.full(3 * N // 4, 0xDEADBEEF, dtype=np.uint32),
                            rng.integers(0, 2**32, size=N // 4, dtype=np.uint32)])
        rng.shuffle(x)
        return [x], pay
    if name == "hot_bucket":  # ~88% of rows in one multi-key bucket
        x = rng.integers(0, 1 << 8, size=N, dtype=np.uint64)
        x[: N // 8] = rng.integers(0, 2**64, size=N // 8, dtype=np.uint64)
        return _u64_planes(x), pay
    if name == "deep_hot":  # concentrated four 16-bit fields deep
        def field():
            v = rng.integers(0, 1 << 16, size=N).astype(np.uint64)
            v[rng.random(N) < 0.9] = 0
            return v
        lo = rng.integers(0, 1 << 16, size=N).astype(np.uint64)
        x = ((field() << np.uint64(48)) | (field() << np.uint64(32))
             | (field() << np.uint64(16)) | lo)
        return _u64_planes(x), pay
    if name == "funnel":  # chip column 0 holds the top hosts' rows
        lo = rng.integers(0, 1 << 31, size=N, dtype=np.uint32)
        hi = rng.integers(1 << 31, 1 << 32, size=N, dtype=np.uint32).astype(np.uint32)
        x = lo.copy()
        for s in range(0, D, 4):
            x[s * N_LOCAL:(s + 1) * N_LOCAL] = hi[s * N_LOCAL:(s + 1) * N_LOCAL]
        return [x], []
    if name == "fact":
        return [rng.integers(0, 2**32, size=N, dtype=np.uint32)], pay
    if name == "other":  # half of it shares keys with "fact"
        fact = _inputs("fact")[0][0]
        x = np.concatenate([fact[: N // 2],
                            rng.integers(0, 2**32, N // 2, dtype=np.uint32)])
        return [x], [np.arange(N, dtype=np.uint32) * 3]
    raise KeyError(name)


def _mesh(shape):
    if len(shape) == 1:
        return tp.make_mesh(shape[0], device="cpu")
    return tp.make_mesh_2d(*shape, device="cpu")


def _run(name, mesh, rows):
    """Case ``name`` on ``mesh`` with the rows ``rows`` selects (this
    process's, or all): a list of ``(words, payloads, counts)`` results and
    the partition, where the case makes one."""
    shape, inp, entry, kw, conf = CASES[name]
    words, pays = _inputs(inp)
    words, pays = [w[rows] for w in words], [p[rows] for p in pays]
    axis = mesh.axis_names if len(shape) == 2 else "shard"
    saved = {k: getattr(config, k) for k in conf}
    for k, v in conf.items():
        setattr(config, k, v)
    try:
        if entry == "sort":
            return [tp.distributed_sort(words, pays, mesh=mesh, axis=axis, **kw)], None
        if entry == "auto":
            return [tp.distributed_sort_auto(words, pays, mesh=mesh, axis=axis,
                                             **kw)], None
        first = tp.distributed_sort(words, pays, mesh=mesh, split_uniform=False,
                                    return_partition=True, **kw)
        ow, op = _inputs("other")
        second = tp.partition_exchange([w[rows] for w in ow], [p[rows] for p in op],
                                       first[3], mesh=mesh, **kw)
        return [first[:3], second], first[3]
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


def _u32(t):
    """A 4-byte plane as u32 numpy, bit for bit."""
    return t.view(torch.int32).numpy().view(np.uint32)


def _rank_checks(world, rank, init):
    """What a rank checks about the backend, as booleans."""
    out = {}
    tp.init_distributed(device="cpu", init_method=init, rank=rank, world_size=world)
    out["init_twice_noop"] = tp.init_distributed(
        device="cpu", init_method=init + ".other", rank=rank, world_size=world) is None
    mesh = tp.make_mesh(8, device="cpu")
    out["spans"] = mesh.processes and list(mesh.shards) == list(
        range(rank * 8 // world, (rank + 1) * 8 // world))
    try:
        mesh.psum([torch.zeros(2, dtype=torch.uint32)] * mesh.n_local)
        out["uint32_raises"] = False
    except TypeError as e:
        out["uint32_raises"] = "uint32" in str(e)
    try:
        tp.make_mesh(world + 1 if world > 2 else 3, device="cpu")
        out["indivisible_raises"] = False
    except ValueError:
        out["indivisible_raises"] = True
    return out


def _child(world, rank, init, outdir):
    """One rank: the checks, then every case on its own rows."""
    torch.set_num_threads(1)
    out = pathlib.Path(outdir)
    checks = _rank_checks(world, rank, init)
    for name, (shape, *_rest) in CASES.items():
        mesh = _mesh(shape)
        L = mesh.n_local
        results, part = _run(name, mesh, slice(rank * L * N_LOCAL, (rank + 1) * L * N_LOCAL))
        for i, (w, p, c) in enumerate(results):
            planes = list(w) + list(p)
            np.save(out / f"{name}.{i}.{rank}.planes.npy", np.stack([_u32(x) for x in planes]))
            np.save(out / f"{name}.{i}.{rank}.counts.npy", c.numpy())
            try:
                g = tp.gather_valid(planes, c, mesh=mesh)
                np.save(out / f"{name}.{i}.{rank}.gathered.npy",
                        np.stack([x.view(np.uint32) for x in g]))
            except OverflowError:
                checks[f"{name}.{i}.gather_overflows"] = True
        if part is not None:
            np.save(out / f"{name}.{rank}.partition.npy",
                    np.stack([x.numpy().astype(np.int64) for x in part[:3]]))
    checks["no_jax"] = "jax" not in sys.modules and "rdst_tpu.parallel" not in sys.modules
    checks["transport"] = dict(tmesh.TRANSPORT)
    (out / f"checks.{rank}.json").write_text(json.dumps(checks))
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def _start(world, tmp, script=__file__):
    """``world`` ranks of ``script --child``, each given its rank, the
    rendezvous file in ``tmp`` and ``tmp`` for its outputs."""
    init = "file://" + str(tmp / "rendezvous")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(pathlib.Path(script).resolve()), "--child",
         str(world), str(r), init, str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _wait(procs):
    """Wait for every rank under its time limit; kill them all past it or
    when one fails, and fail with the stderr."""
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=CHILD_SECONDS)
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r}: no exit within {CHILD_SECONDS} s")
                break
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errors:
        pytest.fail("\n".join(errors))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both world sizes, started together, waited for when first needed;
    each with its own directory and rendezvous file."""
    tmps = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}
    procs = {w: _start(w, tmps[w]) for w in (2, 4)}
    done = {}

    def get(world):
        if world not in done:
            _wait(procs[world])
            done[world] = tmps[world]
        return done[world]

    yield get
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


_ONE = {}


def one_process_result(name):
    """Case ``name`` on the port's one-process mesh of the same shape,
    computed once a process."""
    if name not in _ONE:
        _ONE[name] = _run(name, _mesh(CASES[name][0]), slice(None))
    return _ONE[name]


@pytest.fixture(scope="module")
def one_process():
    return one_process_result


def _gathered(out, name, i, world):
    planes = np.concatenate([np.load(out / f"{name}.{i}.{r}.planes.npy")
                             for r in range(world)], axis=1)
    counts = [np.load(out / f"{name}.{i}.{r}.counts.npy") for r in range(world)]
    for c in counts[1:]:
        np.testing.assert_array_equal(c, counts[0])  # replicated
    return planes, counts[0]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_matches_one_process_mesh(runs, one_process, name, world):
    """Every plane (pads included), the counts, the partition and
    ``gather_valid``'s global order equal the one-process mesh's."""
    out = runs(world)
    results, part = one_process(name)
    for i, (w, p, c) in enumerate(results):
        planes, counts = _gathered(out, name, i, world)
        np.testing.assert_array_equal(counts, c.numpy())
        want = np.stack([_u32(x) for x in list(w) + list(p)])
        np.testing.assert_array_equal(planes, want)
        try:
            ref = np.stack([x.view(np.uint32) for x in tp.gather_valid(list(w) + list(p), c)])
        except OverflowError:
            checks = json.loads((out / "checks.0.json").read_text())
            assert checks.get(f"{name}.{i}.gather_overflows")
            continue
        for r in range(world):
            np.testing.assert_array_equal(np.load(out / f"{name}.{i}.{r}.gathered.npy"), ref)
    if part is not None:
        want = np.stack([x.numpy().astype(np.int64) for x in part[:3]])
        for r in range(world):
            np.testing.assert_array_equal(np.load(out / f"{name}.{r}.partition.npy"), want)


_JAX = {}


def jax_result(name):
    """The JAX package's output of case ``name`` on its virtual 8-device
    mesh, computed once a process (imported here: the children never
    import it)."""
    if name in _JAX:
        return _JAX[name]
    import jax
    from test_exchange_parity import _emulated_ragged_all_to_all

    import rdst_tpu.config as jconfig
    from rdst_tpu import parallel as jp
    shape, inp, entry, kw, conf = CASES[name]
    words, pays = _inputs(inp)
    mesh = jp.make_mesh(8) if len(shape) == 1 else jp.make_mesh_2d(*shape)
    extra = dict(axis=mesh.axis_names) if len(shape) == 2 else {}
    saved = {k: getattr(jconfig, k) for k in conf}
    real = jax.lax.ragged_all_to_all
    try:
        for k, v in conf.items():
            setattr(jconfig, k, v)
        if conf:  # the stage-1 overflow: the ragged branch, emulated
            jax.lax.ragged_all_to_all = _emulated_ragged_all_to_all
            extra["use_ragged"] = True
        if entry == "sort":
            res = [jp.distributed_sort(words, pays, mesh=mesh, **extra, **kw)]
        elif entry == "auto":
            res = [jp.distributed_sort_auto(words, pays, mesh=mesh, **extra, **kw)]
        else:
            first = jp.distributed_sort(words, pays, mesh=mesh, split_uniform=False,
                                        return_partition=True, **kw)
            ow, op = _inputs("other")
            res = [first[:3], jp.partition_exchange(ow, op, first[3], mesh=mesh, **kw)]
    finally:
        jax.lax.ragged_all_to_all = real
        for k, v in saved.items():
            setattr(jconfig, k, v)
    _JAX[name] = res
    return res


@pytest.fixture(scope="module")
def jax_side():
    return jax_result


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(runs, jax_side, name, world):
    """The ranks' reassembled output against the JAX package's, by
    ``test_torch_shuffle.py``'s rules (counts equal; stable: valid slices
    bit-equal; unstable: keys bit-equal, each shard's rows as multisets;
    the stage-1 overflow: counts, which are poisoned past the capacity)."""
    from test_torch_shuffle import _assert_same

    out = runs(world)
    shape, inp, entry, kw, conf = CASES[name]
    n_words = len(_inputs(inp)[0])
    if entry == "partition":
        n_words = 1
    for i, want in enumerate(jax_side(name)):
        planes, counts = _gathered(out, name, i, world)
        if conf:
            np.testing.assert_array_equal(counts, np.asarray(want[2]))
            assert counts.max() > planes.shape[1] // D
            continue
        pays = [np.asarray(x) for x in want[1]]
        got = ([planes[j] for j in range(n_words)],
               [planes[j].view(pays[k].dtype) for k, j in enumerate(range(n_words, len(planes)))],
               counts)
        _assert_same(want, got, n_words, kw.get("stable", False))


def _checks(runs, world):
    out = runs(world)
    return [json.loads((out / f"checks.{r}.json").read_text()) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("check", [
    "init_twice_noop", "spans", "uint32_raises", "indivisible_raises", "no_jax",
])
def test_rank_checks(runs, world, check):
    """On every rank: ``init_distributed`` twice is a no-op; ``make_mesh``
    spans the processes (rank r holds shards [r L, (r + 1) L)); a uint32
    value into a collective raises, naming its dtype; a shard count that
    does not split over the ranks raises; no rank imported JAX."""
    for c in _checks(runs, world):
        assert c[check] is True


@pytest.mark.parametrize("world", [2, 4])
def test_transport_moves_only_what_lands(runs, world):
    """Each cross-process exchange reads the size matrix once and makes one
    all_to_all; the words a rank sends are all received somewhere."""
    cs = _checks(runs, world)
    t = [c["transport"] for c in cs]
    assert all(x["calls"] == t[0]["calls"] == x["host_reads"] > 0 for x in t)
    assert sum(x["bytes_sent"] for x in t) == sum(x["bytes_received"] for x in t) > 0
    assert all(x["host_copy_bytes"] == 0 for x in t)  # CPU shards: no copy


def test_mesh_over_processes_needs_a_group():
    """A mesh spans processes only inside a process group of more than one
    rank: without ``init_distributed`` it holds every shard, spans no group
    and calls nothing (a collective of int32 values runs locally: only one
    that crosses processes needs int64)."""
    assert not torch.distributed.is_initialized()
    for m in (tp.make_mesh(8, device="cpu"), tp.make_mesh_2d(2, 4, device="cpu")):
        assert not m.processes and m.world == 1 and list(m.shards) == list(range(8))
        assert m.spans(m.groups(m.axis_names[0])) is False
        got = m.psum([torch.ones(2, dtype=torch.int32)] * 8)
        assert got.tolist() == [8, 8]


def test_gather_valid_without_mesh_unchanged():
    """``gather_valid`` keeps its one-process behaviour by default and with
    a one-process mesh."""
    m = tp.make_mesh(4, device="cpu")
    planes = [torch.arange(16, dtype=torch.int32).view(torch.uint32)]
    counts = torch.tensor([1, 0, 4, 2])
    want = [np.array([0, 8, 9, 10, 11, 12, 13], np.uint32)]
    for got in (tp.gather_valid(planes, counts), tp.gather_valid(planes, counts, mesh=m)):
        np.testing.assert_array_equal(got[0], want[0])


# JAX, the JAX package, or its root entry points (bench.py, __graft_entry__.py)
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|rdst_tpu|bench|__graft_entry__)(\.|\s|$)",
                     re.M)
# a JAX script of scripts/ (the port's scripts are scripts/torch_*.py)
_JAX_SCRIPT = re.compile(r"^\s*(import|from)\s+scripts(\.(?!torch_)\w+|\s+import\s+(?!torch_))",
                         re.M)


# the test files that run as gloo children: their parents import JAX inside
# functions the children never call, so only their top level counts
_CHILDREN = ("tests/test_torch_distributed.py", "tests/test_torch_dtable_distributed.py",
             "tests/test_torch_ranks_cards.py")


@pytest.mark.parametrize("where", [
    "rdst_tpu_torch", "chip_smoke.py", "scripts/torch_bench_suite.py",
    "scripts/torch_bench_single_algo.py", "scripts/torch_timings.py",
    "scripts/torch_capacity_study.py", "scripts/torch_bench_mesh.py",
    "scripts/torch_suite_steps.py", "scripts/torch_acceptance.py",
    "scripts/torch_floor_table.py", "scripts/torch_span_split.py",
    "scripts/torch_shuffle_stages.py", "scripts/torch_regions_stages.py",
    "scripts/torch_table_stages.py", "tests/flow_cases.py", "fixtures/torch_consumer.py",
    "torch_bench.py", "torch_graft_entry.py", *_CHILDREN])
def test_port_imports_no_jax(where):
    """No module of the port, not ``chip_smoke.py``, none of the port's
    harnesses, its consumer fixture or its root entry points imports JAX,
    the JAX package (``rdst_tpu``; ``rdst_tpu_torch`` is the port), a JAX
    script or a JAX root entry point; nor does the top level of a test file
    that runs as a child, or of a test module it imports."""
    path = ROOT / where
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    for f in files:
        text = f.read_text()
        if where in _CHILDREN:
            tops = re.findall(r"^(?:import|from)\s+(test_\w+)", text, re.M)
            files.extend(ROOT / "tests" / f"{m}.py" for m in tops
                         if ROOT / "tests" / f"{m}.py" not in files)
            text = "\n".join(x for x in text.splitlines() if not x[:1].isspace())
        hits = _IMPORT.findall(text) + _JAX_SCRIPT.findall(text)
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"



@pytest.mark.parametrize("where", ["tests", "scripts"])
def test_no_test_or_script_imports_chip_smoke(where):
    """``chip_smoke.py`` drives the card and is no library: the tests and
    scripts share their case tables through modules of their own
    (``tests/flow_cases.py``), so no slip in the card script can stop a
    CPU test from importing.  Running it as a child or reading its text
    stays."""
    imports = re.compile(r"^\s*(?:import|from)\s+chip_smoke\b", re.M)
    hits = [str(f.relative_to(ROOT)) for f in sorted((ROOT / where).rglob("*.py"))
            if imports.search(f.read_text())]
    assert not hits

def test_entry_points_default_to_the_card():
    """Every public function or class of the port that takes ``device``
    defaults it to the card ("cuda") or takes it from its input; the
    multi-process start defaults to NCCL on the card."""
    import importlib
    import pkgutil

    import rdst_tpu_torch

    seen = 0
    for m in pkgutil.walk_packages(rdst_tpu_torch.__path__, "rdst_tpu_torch."):
        if any(part.startswith("_") for part in m.name.split(".")):
            continue
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != m.name:
                continue
            fn = obj.__init__ if inspect.isclass(obj) else obj
            if not callable(fn):
                continue
            try:
                sig = inspect.signature(fn)
            except (TypeError, ValueError):
                continue
            p = sig.parameters.get("device")
            if p is not None and p.default is not inspect.Parameter.empty:
                assert p.default == "cuda", f"{m.name}.{name}: device={p.default!r}"
                seen += 1
    assert seen >= 10
    assert inspect.signature(tp.init_distributed).parameters["backend"].default is None


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    world, rank = int(sys.argv[2]), int(sys.argv[3])
    sys.exit(_child(world, rank, sys.argv[4], sys.argv[5]))
