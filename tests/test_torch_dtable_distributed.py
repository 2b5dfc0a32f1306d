"""The port's table operators over processes (``distributed_sort_table``,
``_filter``, ``_group_aggregate`` and ``_join`` on a mesh over the default
process group) against its one-process mesh and the JAX package's virtual
8-device mesh.

Each world size (2 and 4) starts its ranks once, as fresh processes running
this file (:func:`_child`), with gloo on the CPU and a ``file://``
rendezvous in a temporary directory of its own (the spawn, rendezvous and
time limit of ``test_torch_distributed.py``).  Every rank runs every case of
``CASES`` on its own rows (the rows of its ``8 // world`` shards, ``N_LOCAL``
a shard for the main table) and writes its output columns with
``np.savez`` and its counts, or the ``OverflowError`` it raised, to a JSON
record.  The parent reassembles the
columns rank by rank and holds them bit-equal, every column, count and row
order, to the port's one-process mesh of the same shape, and to the JAX
package by ``test_torch_dtable.py``'s ``_same`` (bit-equal, except a float
``sum`` within 1e-9 x sum(|x|) of its group and ``mean`` within rtol 1e-6).
The global counts must be equal on every rank.  Each child runs under its
own time limit and is killed past it, so a rank that hangs fails the test.
The children import neither JAX nor ``rdst_tpu``.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from rdst_tpu_torch import config
from rdst_tpu_torch import parallel as tp
from rdst_tpu_torch.parallel import mesh as tmesh
from rdst_tpu_torch.table import Table
from test_torch_distributed import _start, _wait

N_LOCAL = 1 << 12  # rows a shard of the main table
D = 8
N = D * N_LOCAL

_ALL_OPS = {"s": ("q", "sum"), "c": ("q", "count"), "mx": ("q", "max"),
            "mn": ("v", "min"), "lst": ("q", "last"), "fst": ("v", "first"),
            "avg": ("q", "mean")}
_WIDE = {"xs": ("x", "sum"), "xmin": ("x", "min"), "umax": ("u", "max"),
         "umin": ("u", "min"), "fs": ("f", "sum"), "fl": ("f", "last"),
         "oks": ("ok", "sum"), "okl": ("ok", "last"), "bmax": ("b", "max"),
         "n": ("x", "count")}
_JOIN_DUP = dict(capacity_factor=6.0, right_capacity_factor=10.0,
                 join_capacity_factor=40.0)

# name: (mesh shape, operator, input, positional arguments, keyword
# arguments, config overrides).  A string argument "mask" is the input's
# filter mask, cut to the rank's rows like the table.
CASES = {
    "sort_table_stable": ((8,), "distributed_sort_table", "keyed", ("key",),
                          dict(stable=True), {}),
    "sort_table_unstable": ((8,), "distributed_sort_table", "keyed", ("key",),
                            dict(stable=False), {}),
    "sort_table_overlap": ((8,), "distributed_sort_table", "keyed", ("key",),
                           dict(stable=True, overlap_exchange=True), {}),
    "filter": ((8,), "distributed_filter", "keyed", ("mask",), {}, {}),
    "aggregate_range": ((8,), "distributed_group_aggregate", "spanning",
                        ("grp", _ALL_OPS), dict(capacity_factor=2.5), {}),
    "aggregate_hash": ((8,), "distributed_group_aggregate", "spanning",
                       ("grp", _ALL_OPS), dict(capacity_factor=2.5, partition="hash"),
                       {}),
    "aggregate_mesh2d_2x4": ((2, 4), "distributed_group_aggregate", "spanning",
                             ("grp", _ALL_OPS), dict(capacity_factor=2.5), {}),
    "aggregate_wide_values": ((8,), "distributed_group_aggregate", "wide",
                              (["a", "b"], _WIDE), {}, {}),
    "join_inner_range": ((8,), "distributed_join", "pk_fk", ("key",),
                         dict(right_capacity_factor=6.0), {"replicate_capacity_max": 0}),
    "join_inner_hash": ((8,), "distributed_join", "pk_fk", ("key",),
                        dict(right_capacity_factor=6.0, partition="hash"),
                        {"replicate_capacity_max": 0}),
    "join_left": ((8,), "distributed_join", "left", ("key",),
                  dict(how="left", right_capacity_factor=10.0), {}),
    "join_left_hash": ((8,), "distributed_join", "left", ("key",),
                       dict(how="left", right_capacity_factor=10.0, partition="hash"),
                       {}),
    "join_duplicate_right": ((8,), "distributed_join", "duplicates", ("key",),
                             dict(_JOIN_DUP, partition="hash"), {}),
    "join_small_right": ((8,), "distributed_join", "hot_fk", ("key",),
                         dict(capacity_factor=8.0), {}),
    "join_mesh2d_2x4": ((2, 4), "distributed_join", "pk_fk", ("key",),
                        dict(right_capacity_factor=6.0, partition="hash"), {}),
    "join_output_overflow": ((8,), "distributed_join", "one_shard_expands", ("key",),
                             dict(capacity_factor=2.0), {}),
}
# the float sums, compared within 1e-9 x sum(|x|) of each group: case ->
# (key names, {out_name: value column})
FSUMS = {"aggregate_wide_values": (["a", "b"], {"fs": "f"})}
MEANS = ("avg",)


def _spanning_groups(rng, n):
    """One hot key on 3/4 of the rows: the shuffle rank-splits its bucket
    over several shards, across the process boundary."""
    grp = np.full(n, 7, dtype=np.uint32)
    grp[: n // 8] = rng.integers(0, 5, n // 8).astype(np.uint32)
    grp[-n // 8:] = rng.integers(900, 905, n // 8).astype(np.uint32)
    rng.shuffle(grp)
    return grp


def _inputs(name):
    """The tables of input ``name`` (dicts of numpy columns; their row
    counts divisible by 8) and its mask, made from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "keyed":  # an int64 key and a float column
        t = {"key": rng.integers(-2**62, 2**62, N), "x": rng.standard_normal(N),
             "id": np.arange(N, dtype=np.uint32)}
        return [t], t["x"] > 0.3
    if name == "spanning":
        return [{"grp": _spanning_groups(rng, N),
                 "q": rng.integers(0, 1000, N).astype(np.uint32),
                 "v": rng.standard_normal(N).astype(np.float32)}], None
    if name == "wide":  # 64-bit, float and bool values; a composite key
        return [{"a": rng.integers(0, 3, N).astype(np.int16),
                 "b": rng.integers(0, 5, N).astype(np.uint32),
                 "x": rng.integers(-2**50, 2**50, N),
                 "u": rng.integers(0, 2**64, N, dtype=np.uint64),
                 "f": rng.standard_normal(N),
                 "ok": rng.integers(0, 2, N).astype(bool)}], None
    if name == "pk_fk":
        m = 1 << 10
        rk = rng.choice(2 * m, size=m, replace=False).astype(np.uint32)
        return [{"key": rng.integers(0, 2 * m, N).astype(np.uint32),
                 "lid": np.arange(N, dtype=np.uint32)},
                {"key": rk, "dim": (rk * 7 + 1).astype(np.uint32)}], None
    if name == "left":
        m = 1 << 9
        rk = rng.permutation(m).astype(np.uint32)
        return [{"key": rng.integers(0, 4 * m, N).astype(np.uint32),
                 "lid": np.arange(N, dtype=np.uint32), "w": rng.standard_normal(N)},
                {"key": rk, "dim": (rk + 100).astype(np.uint32),
                 "w": rng.integers(-5, 5, m).astype(np.int64)}], None
    if name == "duplicates":  # int64 keys, 64 values, repeated on both sides
        vals = rng.integers(-2**40, 2**40, 64)
        return [{"key": vals[rng.integers(0, 64, N)], "lid": np.arange(N, dtype=np.uint32)},
                {"key": vals[rng.integers(0, 64, 512)],
                 "rid": np.arange(512, dtype=np.uint32)}], None
    if name == "hot_fk":  # 70% of the rows reference one of 256 keys
        lk = np.concatenate([np.full(int(N * 0.7), 42, dtype=np.uint32),
                             rng.integers(0, 256, N - int(N * 0.7)).astype(np.uint32)])
        rng.shuffle(lk)
        rk = np.arange(256, dtype=np.uint32)
        return [{"key": lk, "lid": np.arange(N, dtype=np.uint32)},
                {"key": rk, "dim": rk * 3}], None
    if name == "one_shard_expands":
        # unique right keys but the largest, which repeats 64 times: only
        # the last shard's expansion passes its capacity
        lk = rng.integers(0, 2048, N).astype(np.uint32)
        lk[rng.choice(N, 256, replace=False)] = 5000
        rk = np.concatenate([np.arange(2048), np.full(64, 5000)]).astype(np.uint32)
        return [{"key": lk, "lid": np.arange(N, dtype=np.uint32)},
                {"key": rk, "rid": np.arange(rk.size, dtype=np.uint32)}], None
    raise KeyError(name)


def _mesh(shape):
    if len(shape) == 1:
        return tp.make_mesh(shape[0], device="cpu")
    return tp.make_mesh_2d(*shape, device="cpu")


def _run(name, mesh, world=1, rank=0):
    """Case ``name`` on ``mesh`` with rank ``rank``'s share of every input
    (all of it for ``world`` 1): (Table, counts) or the ``OverflowError``."""
    shape, op, inp, args, kw, conf = CASES[name]
    tables, mask = _inputs(inp)

    def mine(x):
        k = len(x) // world
        return x[rank * k:(rank + 1) * k]

    tabs = [Table({c: mine(v) for c, v in t.items()}, device="cpu") for t in tables]
    args = [mine(mask) if a == "mask" else a for a in args]
    if len(shape) == 2:
        kw = dict(kw, axis=mesh.axis_names)
    saved = {k: getattr(config, k) for k in conf}
    for k, v in conf.items():
        setattr(config, k, v)
    try:
        return getattr(tp, op)(*tabs, *args, mesh=mesh, **kw)
    except OverflowError as e:
        return e
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _child(world, rank, init, outdir):
    """One rank: every case on its own rows."""
    torch.set_num_threads(1)
    out = pathlib.Path(outdir)
    tp.init_distributed(device="cpu", init_method=init, rank=rank, world_size=world)
    record = {}
    for name, (shape, *_rest) in CASES.items():
        res = _run(name, _mesh(shape), world, rank)
        if isinstance(res, OverflowError):
            record[name] = {"raised": str(res)}
            continue
        table, count = res
        record[name] = {"columns": table.column_names, "count": _np(count).tolist()}
        np.savez(out / f"{name}.{rank}.npz",
                 **{f"c{i}": _np(table[c]) for i, c in enumerate(table.column_names)})
    record["no_jax"] = "jax" not in sys.modules and "rdst_tpu.parallel" not in sys.modules
    record["transport"] = dict(tmesh.TRANSPORT)
    (out / f"record.{rank}.json").write_text(json.dumps(record))
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both world sizes, started together, waited for when first needed."""
    tmps = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 4)}
    procs = {w: _start(w, tmps[w], __file__) for w in (2, 4)}
    done = {}

    def get(world):
        if world not in done:
            _wait(procs[world])
            done[world] = [json.loads((tmps[world] / f"record.{r}.json").read_text())
                           for r in range(world)]
        return tmps[world], done[world]

    yield get
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _reassembled(runs, name, world):
    """The ranks' outputs, rank by rank, as (Table, counts), or the
    ``OverflowError`` message every rank raised."""
    out, records = runs(world)
    recs = [r[name] for r in records]
    if "raised" in recs[0]:
        assert all(r.get("raised") == recs[0]["raised"] for r in recs), recs
        return recs[0]["raised"]
    for r in recs[1:]:
        assert r["count"] == recs[0]["count"]  # global: equal on every rank
        assert r["columns"] == recs[0]["columns"]
    parts = [np.load(out / f"{name}.{r}.npz") for r in range(world)]
    cols = {c: np.concatenate([p[f"c{i}"] for p in parts])
            for i, c in enumerate(recs[0]["columns"])}
    return Table(cols, device="cpu"), recs[0]["count"]


@pytest.fixture(scope="module")
def one_process():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(name, _mesh(CASES[name][0]))
        return cache[name]
    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_matches_one_process_mesh(runs, one_process, name, world):
    """Every column, bit for bit and in row order, and the counts equal the
    one-process mesh's (``_same`` with no tolerance); an overflow raises on
    every rank as it does there."""
    from test_torch_dtable import _same

    got = _reassembled(runs, name, world)
    want = one_process(name)
    if isinstance(want, OverflowError):
        assert got == str(want)
        return
    assert not isinstance(got, str), got
    _same(want, (got[0], np.asarray(got[1])))


@pytest.fixture(scope="module")
def jax_side():
    """Each case on the JAX package's virtual 8-device mesh (imported here:
    the children never import it)."""
    import rdst_tpu.config as jconfig
    from rdst_tpu import parallel as jp
    from rdst_tpu.parallel import dtable as jd
    from rdst_tpu.table import Table as JTable
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        shape, op, inp, args, kw, conf = CASES[name]
        tables, mask = _inputs(inp)
        mesh = jp.make_mesh(8) if len(shape) == 1 else jp.make_mesh_2d(*shape)
        if len(shape) == 2:
            kw = dict(kw, axis=mesh.axis_names)
        args = [mask if a == "mask" else a for a in args]
        saved = {k: getattr(jconfig, k) for k in conf}
        try:
            for k, v in conf.items():
                setattr(jconfig, k, v)
            cache[name] = getattr(jd, op)(*[JTable(t) for t in tables], *args,
                                          mesh=mesh, **kw)
        except OverflowError as e:
            cache[name] = e
        finally:
            for k, v in saved.items():
                setattr(jconfig, k, v)
        return cache[name]
    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(runs, jax_side, name, world):
    """The ranks' reassembled output against the JAX package's by
    ``test_torch_dtable.py``'s rules; an overflow raises in both."""
    from test_torch_dtable import _same

    got = _reassembled(runs, name, world)
    want = jax_side(name)
    if isinstance(want, OverflowError):
        assert isinstance(got, str) and "join_capacity_factor" in got, got
        assert "join_capacity_factor" in str(want)
        return
    assert not isinstance(got, str), got
    fsums = None
    if name in FSUMS:
        by, sums = FSUMS[name]
        fsums = (_inputs(CASES[name][2])[0][0], by, sums)
    _same(want, (got[0], np.asarray(got[1])), means=MEANS, fsums=fsums)


@pytest.mark.parametrize("world", [2, 4])
def test_children_import_no_jax(runs, world):
    """No rank imported JAX or the JAX package; every rank read counts on
    the host (the cross-process exchanges' size matrices and the
    operators' gathered counts) and moved rows between processes."""
    _, records = runs(world)
    for r in records:
        assert r["no_jax"] is True
        t = r["transport"]
        assert t["host_reads"] > t["calls"] > 0 and t["bytes_received"] > 0


def test_overflow_case_overflows_on_one_shard(monkeypatch):
    """The overflow case's expansion passes its capacity on the last shard
    alone (so over processes only the last rank sees it locally), and the
    one-process mesh raises the join-output ``OverflowError``."""
    from rdst_tpu_torch.parallel import dtable as td

    sizes = []
    real = td._join_local

    def spy(*a):
        out = real(*a)
        sizes.append((int(out[1]), a[6]))  # (output rows, capacity)
        return out

    monkeypatch.setattr(td, "_join_local", spy)
    got = _run("join_output_overflow", _mesh((8,)))
    assert isinstance(got, OverflowError) and "join_capacity_factor" in str(got)
    assert [rows > cap for rows, cap in sizes] == [False] * 7 + [True]


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    world, rank = int(sys.argv[2]), int(sys.argv[3])
    sys.exit(_child(world, rank, sys.argv[4], sys.argv[5]))
