"""The port's distributed table pipeline (rdst_tpu_torch.parallel.dtable)
against the JAX package's (rdst_tpu.parallel.dtable), one counterpart of
every case in ``test_dtable.py`` and more.

The JAX side runs on the virtual 8-device CPU mesh of ``conftest.py``; the
port runs ``make_mesh(8, device="cpu")``, whose exchange is kernel B6's
plain version.  Both get the same numpy columns, made from a seed.

Tolerances: every output column, the per-shard counts and the group and
match counts are bit-equal, in the same row order (hash-partitioned
results included: the hash plane is bit-equal), except a float ``sum``,
within 1e-9 x sum(|x|) of its group (cumsums of another order round
differently), and ``mean``, float32 within rtol 1e-6.  The overflow cases
raise ``OverflowError`` in both packages.
"""
import collections

import numpy as np
import pytest
import torch

from rdst_tpu import parallel as jp
from rdst_tpu.parallel import dtable as jd
from rdst_tpu.table import Table as JTable
from rdst_tpu_torch import _build, config
from rdst_tpu_torch import parallel as tp
from rdst_tpu_torch.parallel import dtable as td
from rdst_tpu_torch.parallel import shuffle as sh
from rdst_tpu_torch.table import Table
from test_torch_dtable_distributed import _spanning_groups

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return jp.make_mesh(8), tp.make_mesh(8, device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    x = _np(x)
    return x.view(f"u{x.dtype.itemsize}") if x.dtype.kind == "f" else x


def _run(fn_name, meshes, tables, *args, **kw):
    """The same operator on both packages; returns (JAX result, port's)."""
    jm, tm = meshes
    jt = [JTable(t) for t in tables]
    tt = [Table(t, device="cpu") for t in tables]
    want = getattr(jd, fn_name)(*jt, *args, mesh=jm, **kw)
    got = getattr(td, fn_name)(*tt, *args, mesh=tm, **kw)
    return want, got


def _same(want, got, means=(), fsums=None):
    """``fsums``: (input columns, key names, {out_name: value column}) of
    the float sums, compared within 1e-9 x sum(|x|) of each group."""
    (wt, wc), (gt, gc) = want, got
    np.testing.assert_array_equal(_np(gc), _np(wc))
    assert gt.column_names == wt.column_names
    assert gt.n_rows == wt.n_rows
    cols, by, sums = fsums or (None, None, {})
    for c in wt.column_names:
        a, b = _np(wt[c]), _np(gt[c])
        assert a.dtype == b.dtype, c
        if c in means:
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=c)
        elif c in sums:
            scale = collections.defaultdict(float)
            for key, x in zip(zip(*[cols[k].tolist() for k in by]), cols[sums[c]]):
                scale[key] += abs(x)
            rows = zip(*[_np(gt[k]).tolist() for k in by])
            assert np.all(np.abs(a - b) <= 1e-9 * np.array([scale[r] for r in rows]))
        else:
            np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=c)


@pytest.fixture()
def sales():
    rng = np.random.default_rng(11)
    n = 1 << 14
    return {
        "key": rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32),
        "grp": rng.integers(0, 64, n).astype(np.uint32),
        "qty": rng.integers(1, 50, n).astype(np.uint32),
        "id": np.arange(n, dtype=np.uint32),
    }


def test_hash_plane_extreme_words():
    """Bit-equal to the reference's u32 arithmetic on 0, 1, 2^31 and
    2^32 - 1 in every position of one to three words."""
    import jax.numpy as jnp

    ext = np.array([0, 1, 1 << 31, 0xFFFFFFFF], np.uint32)
    rng = np.random.default_rng(12)
    for k in (1, 2, 3):
        grid = np.stack(np.meshgrid(*[ext] * k, indexing="ij")).reshape(k, -1)
        words = np.concatenate(
            [grid, rng.integers(0, 2**32, (k, 1000), dtype=np.int64)
             .astype(np.uint32)], 1)
        want = np.asarray(jd._hash_plane([jnp.asarray(w) for w in words]))
        got = td._hash_plane([torch.from_numpy(w) for w in words])
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stable", [True, False])
def test_distributed_sort_table(meshes, sales, stable):
    want, got = _run("distributed_sort_table", meshes, [sales], "key",
                     stable=stable)
    _same(want, got)
    out, counts = got
    cnts = _np(counts)
    assert cnts.sum() == len(sales["key"])
    k = _np(out["key"]).reshape(8, -1)
    dense = np.concatenate([k[d, : cnts[d]] for d in range(8)])
    np.testing.assert_array_equal(dense, np.sort(sales["key"]))


@pytest.mark.parametrize("min_elems, route", [(1024, "B2/B3"), (1 << 30, "lex_sort")])
def test_shuffle_records_sort_routes(meshes, sales, monkeypatch, min_elems, route):
    """``shuffle.SORT_ROUTES`` counts every per-shard sort by the route it
    took, and the fused route runs B2's plain version here (CPU planes)."""
    monkeypatch.setattr(config, "fused_min_elems", min_elems)
    monkeypatch.setattr(config, "bitonic_smem_bytes", 18432)
    tail = _build.KERNELS["bitonic_tail"].plain_calls
    sh.SORT_ROUTES.clear()
    out, counts = td.distributed_sort_table(Table(sales, device="cpu"), "key",
                                            mesh=meshes[1], stable=True)
    assert {r for _, _, r in sh.SORT_ROUTES} == {route}
    # each shard's local sort of its 2^11 rows, then its finish sort
    assert sh.SORT_ROUTES[(4, 1 << 11, route)] == 8
    assert sum(sh.SORT_ROUTES.values()) >= 16
    assert (_build.KERNELS["bitonic_tail"].plain_calls > tail) == (route == "B2/B3")
    k = _np(out["key"]).reshape(8, -1)
    dense = np.concatenate([k[d, : c] for d, c in enumerate(_np(counts))])
    np.testing.assert_array_equal(dense, np.sort(sales["key"]))


def test_distributed_filter(meshes, sales):
    mask = sales["qty"] > 25
    want, got = _run("distributed_filter", meshes, [sales], mask)
    _same(want, got)  # the whole static-length output and the counts
    assert got[1].dtype == torch.int32
    ids, cnts = _np(got[0]["id"]).reshape(8, -1), _np(got[1])
    for d in range(8):
        src = sales["id"].reshape(8, -1)[d]
        np.testing.assert_array_equal(ids[d, : cnts[d]],
                                      src[mask.reshape(8, -1)[d]])


def test_distributed_group_aggregate(meshes, sales):
    want, got = _run("distributed_group_aggregate", meshes, [sales], "grp",
                     {"total": ("qty", "sum"), "cnt": ("qty", "count")})
    _same(want, got)
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(_np(got[0]["grp"]), np.unique(sales["grp"]))


_ALL = {"s": ("q", "sum"), "c": ("q", "count"), "m": ("v", "mean"),
        "lo": ("v", "min"), "hi": ("v", "max"), "f": ("q", "first"),
        "l": ("q", "last")}


def test_distributed_aggregate_all_ops(meshes):
    rng = np.random.default_rng(13)
    n = 1 << 13
    cols = {"grp": rng.integers(0, 37, n).astype(np.uint32),
            "v": rng.standard_normal(n).astype(np.float32),
            "q": rng.integers(0, 100, n).astype(np.int32)}
    _same(*_run("distributed_group_aggregate", meshes, [cols], "grp", _ALL),
          means=("m",))


def test_distributed_aggregate_wide_values_and_key_as_value(meshes):
    """64-bit and bool values, a composite key, and a value column that is
    also a group key (it rides under an alias)."""
    rng = np.random.default_rng(14)
    n = 1 << 12
    cols = {"a": rng.integers(0, 3, n).astype(np.int16),
            "b": rng.integers(0, 5, n).astype(np.uint32),
            "x": rng.integers(-2**50, 2**50, n),
            "u": rng.integers(0, 2**64, n, dtype=np.uint64),
            "f": rng.standard_normal(n),
            "ok": rng.integers(0, 2, n).astype(bool)}
    aggs = {"xs": ("x", "sum"), "xmin": ("x", "min"), "umax": ("u", "max"),
            "umin": ("u", "min"), "fs": ("f", "sum"), "fl": ("f", "last"),
            "oks": ("ok", "sum"), "bmax": ("b", "max"), "n": ("x", "count")}
    _same(*_run("distributed_group_aggregate", meshes, [cols], ["a", "b"], aggs),
          fsums=(cols, ["a", "b"], {"fs": "f"}))


@pytest.mark.parametrize("partition", ["range", "hash"])
def test_distributed_aggregate_boundary_spanning_groups(meshes, partition):
    """One hot key dominates: the shuffle rank-splits its bucket over
    several shards and the boundary combine reassembles one group row."""
    rng = np.random.default_rng(15)
    n = 1 << 13
    cols = {"grp": _spanning_groups(rng, n),
            "q": rng.integers(0, 1000, n).astype(np.uint32),
            "v": rng.standard_normal(n).astype(np.float32)}
    aggs = {"s": ("q", "sum"), "c": ("q", "count"), "mx": ("q", "max"),
            "mn": ("v", "min"), "lst": ("q", "last"), "fst": ("v", "first"),
            "avg": ("q", "mean")}
    want, got = _run("distributed_group_aggregate", meshes, [cols], "grp",
                     aggs, capacity_factor=2.5, partition=partition)
    _same(want, got, means=("avg",))
    keys = np.unique(cols["grp"])
    assert int(got[1]) == len(keys)
    hot = _np(got[0]["grp"]) == 7
    assert int(_np(got[0]["c"])[hot][0]) == int((cols["grp"] == 7).sum())
    assert int(_np(got[0]["lst"])[hot][0]) == int(cols["q"][cols["grp"] == 7][-1])


def test_distributed_aggregate_all_equal_keys(meshes):
    rng = np.random.default_rng(16)
    n = 1 << 12
    cols = {"grp": np.full(n, 42, dtype=np.uint32),
            "q": rng.integers(0, 9, n).astype(np.uint32)}
    want, got = _run("distributed_group_aggregate", meshes, [cols], "grp",
                     {"s": ("q", "sum"), "c": ("q", "count")},
                     capacity_factor=2.5)
    _same(want, got)
    assert int(got[1]) == 1 and int(_np(got[0]["c"])[0]) == n


def test_distributed_aggregate_overflow_and_bad_arguments(meshes):
    """Keys concentrated four 16-bit fields deep (test_overflow.py): more
    than two refinement levels balance, so one shard overflows."""
    rng = np.random.default_rng(17)
    n = 1 << 12

    def field():
        v = rng.integers(0, 1 << 16, size=n).astype(np.uint64)
        v[rng.random(n) < 0.9] = 0
        return v

    grp = ((field() << np.uint64(48)) | (field() << np.uint64(32))
           | (field() << np.uint64(16)) | rng.integers(0, 1 << 16, n).astype(np.uint64))
    cols = {"grp": grp, "q": rng.integers(0, 9, n).astype(np.uint32)}
    aggs = {"s": ("q", "sum")}
    for fn, table, mesh in ((jd.distributed_group_aggregate, JTable(cols), meshes[0]),
                            (td.distributed_group_aggregate,
                             Table(cols, device="cpu"), meshes[1])):
        with pytest.raises(OverflowError, match="raise capacity_factor"):
            fn(table, "grp", aggs, mesh=mesh, capacity_factor=1.2)
        with pytest.raises(ValueError, match="unsupported agg op"):
            fn(table, "grp", {"s": ("q", "median")}, mesh=mesh)
        with pytest.raises(ValueError, match="partition must be"):
            fn(table, "grp", aggs, mesh=mesh, partition="round-robin")


def _join_oracle(lk, rk, rv):
    lut = dict(zip(rk.tolist(), rv.tolist()))
    return {(int(k), i, lut[int(k)]) for i, k in enumerate(lk) if int(k) in lut}


@pytest.mark.parametrize("partition", ["range", "hash"])
def test_distributed_join_inner(meshes, partition):
    rng = np.random.default_rng(18)
    n, m = 1 << 13, 1 << 10
    lk = rng.integers(0, 2 * m, n).astype(np.uint32)
    rk = rng.choice(2 * m, size=m, replace=False).astype(np.uint32)
    left = {"key": lk, "lid": np.arange(n, dtype=np.uint32)}
    right = {"key": rk, "dim": (rk * 7 + 1).astype(np.uint32)}
    (wt, wc), (gt, gc) = _run("distributed_join", meshes, [left, right], "key",
                              right_capacity_factor=6.0, partition=partition)
    _same((wt, wc), (gt, gc))
    assert isinstance(gc, int) and gt.n_rows == gc
    got = set(zip(_np(gt["key"]).tolist(), _np(gt["lid"]).tolist(),
                  _np(gt["dim"]).tolist()))
    assert got == _join_oracle(lk, rk, right["dim"])


@pytest.mark.parametrize("partition", ["range", "hash"])
def test_distributed_join_left(meshes, partition):
    rng = np.random.default_rng(19)
    n, m = 1 << 12, 1 << 9
    lk = rng.integers(0, 4 * m, n).astype(np.uint32)
    rk = rng.permutation(m).astype(np.uint32)
    left = {"key": lk, "lid": np.arange(n, dtype=np.uint32),
            "w": rng.standard_normal(n)}
    right = {"key": rk, "dim": (rk + 100).astype(np.uint32),
             "w": rng.integers(-5, 5, m).astype(np.int64)}
    want, got = _run("distributed_join", meshes, [left, right], "key",
                     how="left", right_capacity_factor=10.0,
                     partition=partition)
    _same(want, got)
    out = got[0]
    assert out.n_rows == n and out.column_names[-2:] == ["w_r", "_matched"]
    matched = _np(out["_matched"])
    assert matched.dtype == bool and not _np(out["dim"])[~matched].any()


def test_distributed_join_hot_fk(meshes):
    """70% of the fact rows reference one dimension key: atomic buckets
    keep it with its dimension row, so one shard takes most rows."""
    rng = np.random.default_rng(20)
    n, m = 1 << 13, 256
    lk = np.concatenate([np.full(int(n * 0.7), 42, dtype=np.uint32),
                         rng.integers(0, m, n - int(n * 0.7)).astype(np.uint32)])
    rng.shuffle(lk)
    rk = np.arange(m, dtype=np.uint32)
    left = {"key": lk, "lid": np.arange(n, dtype=np.uint32)}
    right = {"key": rk, "dim": (rk * 3).astype(np.uint32)}
    want, got = _run("distributed_join", meshes, [left, right], "key",
                     capacity_factor=8.0, right_capacity_factor=8.0)
    _same(want, got)
    assert got[1] == n
    np.testing.assert_array_equal(np.sort(_np(got[0]["lid"])), np.arange(n))


def test_distributed_sort_skew_16bit_split(meshes):
    rng = np.random.default_rng(21)
    n = 1 << 14
    hot = (np.uint32(0xAB) << np.uint32(24)) | rng.integers(
        0, 2**24, n // 2).astype(np.uint32)
    rest = rng.integers(0, 2**32, size=n // 2, dtype=np.int64).astype(np.uint32)
    x = np.concatenate([hot, rest])
    rng.shuffle(x)
    cols = {"key": x, "id": np.arange(n, dtype=np.uint32)}
    want, got = _run("distributed_sort_table", meshes, [cols], "key",
                     capacity_factor=2.0)
    _same(want, got)
    assert _np(got[1]).max() <= 2 * (n // 8)


@pytest.mark.parametrize("dtype, partition", [
    (np.uint32, "range"), (np.uint32, "hash"), (np.int64, "hash")])
def test_distributed_join_duplicate_right_keys(meshes, dtype, partition):
    """Duplicate right keys expand; an int64 key with the hash word is
    wider than one int64 group, so its search is the descent and the run
    end inside each shard's valid prefix."""
    rng = np.random.default_rng(22)
    n, m = 1 << 12, 1 << 9
    vals = (np.arange(64) if dtype == np.uint32
            else rng.integers(-2**40, 2**40, 64)).astype(dtype)
    lk = vals[rng.integers(0, 64, n)]
    rk = vals[rng.integers(0, 64, m)]
    left = {"key": lk, "lid": np.arange(n, dtype=np.uint32)}
    right = {"key": rk, "rid": np.arange(m, dtype=np.uint32)}
    want, got = _run("distributed_join", meshes, [left, right], "key",
                     capacity_factor=6.0, right_capacity_factor=10.0,
                     join_capacity_factor=40.0, partition=partition)
    _same(want, got)
    lut = collections.defaultdict(list)
    for j, k in enumerate(rk):
        lut[int(k)].append(j)
    expect = {(int(k), i, j) for i, k in enumerate(lk) for j in lut[int(k)]}
    assert got[1] == len(expect) == got[0].n_rows
    assert set(zip(_np(got[0]["key"]).tolist(), _np(got[0]["lid"]).tolist(),
                   _np(got[0]["rid"]).tolist())) == expect


def _both_raise(meshes, tables, match, *args, **kw):
    jm, tm = meshes
    with pytest.raises(OverflowError, match=match):
        jd.distributed_join(*[JTable(t) for t in tables], *args, mesh=jm, **kw)
    with pytest.raises(OverflowError, match=match):
        td.distributed_join(*[Table(t, device="cpu") for t in tables], *args,
                            mesh=tm, **kw)


def test_distributed_join_output_overflow_detected(meshes):
    rng = np.random.default_rng(23)
    n, m = 1 << 12, 1 << 9
    left = {"key": rng.integers(0, 8, n).astype(np.uint32),
            "lid": np.arange(n, dtype=np.uint32)}
    right = {"key": rng.integers(0, 8, m).astype(np.uint32),
             "rid": np.arange(m, dtype=np.uint32)}
    _both_raise(meshes, [left, right], "join_capacity_factor", "key",
                capacity_factor=8.0, right_capacity_factor=10.0,
                join_capacity_factor=1.0)
    _both_raise(meshes, [left, right], "raise capacity_factor", "key",
                capacity_factor=1.0)


def test_hash_partitioned_aggregate(meshes):
    """partition="hash" gives the range partition's groups, in hash order."""
    rng = np.random.default_rng(24)
    n = 1 << 12
    cols = {"grp": rng.integers(0, 37, n).astype(np.uint32),
            "qty": rng.integers(1, 9, n).astype(np.uint32)}
    aggs = {"total": ("qty", "sum")}
    want, got = _run("distributed_group_aggregate", meshes, [cols], "grp",
                     aggs, partition="hash")
    _same(want, got)
    rng_t, _ = td.distributed_group_aggregate(Table(cols, device="cpu"), "grp",
                                              aggs, mesh=meshes[1])
    assert dict(zip(_np(got[0]["grp"]).tolist(), _np(got[0]["total"]).tolist())) \
        == dict(zip(_np(rng_t["grp"]).tolist(), _np(rng_t["total"]).tolist()))


def test_hash_partitioned_join_clustered_keys(meshes):
    """Clustered distinct keys concentrate in one range bucket (atomic
    co-partitioning overflows at capacity_factor 1.2); hashing spreads
    them so the same join fits."""
    rng = np.random.default_rng(25)
    n = 1 << 12
    keys = (np.uint32(1 << 30) + rng.integers(0, 64, n)).astype(np.uint32)
    keys[:8] = rng.integers(0, 1 << 30, 8).astype(np.uint32)
    fact = {"k": keys, "v": np.arange(n, dtype=np.uint32)}
    dim = {"k": (np.uint32(1 << 30) + np.arange(64)).astype(np.uint32),
           "w": np.arange(64, dtype=np.uint32) * 5}
    _both_raise(meshes, [fact, dim], "capacity_factor", "k",
                capacity_factor=1.2)
    want, got = _run("distributed_join", meshes, [fact, dim], "k",
                     capacity_factor=1.2, partition="hash")
    _same(want, got)
    np.testing.assert_array_equal(_np(got[0]["w"]),
                                  (_np(got[0]["k"]) - (1 << 30)) * 5)


def test_dtable_argument_checks(meshes):
    """The shuffle's planes still split evenly over the shards (a table of
    any length is padded by the operators, ``tests/test_torch_tpch.py``),
    and static-length counts need a table that does."""
    tm = meshes[1]
    with pytest.raises(ValueError, match="not divisible"):
        sh.distributed_sort([torch.arange(63, dtype=torch.int32).view(torch.uint32)],
                            mesh=tm)
    with pytest.raises(ValueError, match="shards divide"):
        td.distributed_group_aggregate(Table({"k": torch.arange(63)}), "k",
                                       {"n": ("k", "count")}, mesh=tm,
                                       counts=torch.full((8,), 7, dtype=torch.int32))
    t = Table({"k": torch.arange(64, dtype=torch.int32)})
    with pytest.raises(ValueError, match="how must be"):
        td.distributed_join(t, t, "k", mesh=tm, how="outer")
    with pytest.raises(TypeError, match="same width"):  # 1 word against 2
        td.distributed_join(t, Table({"k": torch.arange(64)}), "k", mesh=tm)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.int16, torch.int32,
                                   torch.int64, torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64])
def test_boundary_bits_round_trip(dtype):
    """A first-group partial crosses the boundary combine's int64 gather
    bit for bit: the extremes of each width, -0.0, infinities and NaNs
    with payload bits."""
    width = torch.tensor([], dtype=dtype).element_size()
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[width]
    info = torch.iinfo(ints)
    x = torch.tensor([0, 1, -1, info.min, info.max, info.min + 1, info.max >> 1],
                     dtype=ints)
    if dtype == torch.bool:
        x = torch.tensor([0, 1], dtype=torch.int8)
    x = x.view(dtype)
    packed = td._bits64(x)
    assert packed.dtype == torch.int64
    back = td._from_bits64(packed, dtype)
    assert back.dtype == dtype
    assert torch.equal(back.view(ints), x.view(ints))


def test_operators_send_int64_and_combine_gathers_once(monkeypatch):
    """Every collective the four operators issue carries int64 (what a mesh
    over processes requires), and the aggregate's boundary combine gathers
    once, whatever its number of aggregates."""
    from rdst_tpu_torch.parallel import mesh as tmesh

    stacked, gathers = [], []
    real_stack, real_gather = tmesh.Mesh._stack, tmesh.Mesh.all_gather
    monkeypatch.setattr(tmesh.Mesh, "_stack", lambda self, xs: (
        stacked.extend(x.dtype for x in xs), real_stack(self, xs))[1])
    monkeypatch.setattr(tmesh.Mesh, "all_gather", lambda self, xs: (
        gathers.append(1), real_gather(self, xs))[1])
    combines = []
    real_combine = td._agg_combine

    def combine(*a):
        before = len(gathers)
        out = real_combine(*a)
        combines.append(len(gathers) - before)
        return out

    monkeypatch.setattr(td, "_agg_combine", combine)
    rng = np.random.default_rng(26)
    n = 1 << 12
    mesh = tp.make_mesh(8, device="cpu")
    cols = {"grp": _spanning_groups(rng, n),
            "q": rng.integers(0, 1000, n).astype(np.uint32),
            "v": rng.standard_normal(n).astype(np.float32),
            "ok": rng.integers(0, 2, n).astype(bool)}
    t = Table(cols, device="cpu")
    td.distributed_sort_table(t, "grp", mesh=mesh)
    td.distributed_filter(t, cols["q"] > 500, mesh=mesh)
    aggs = dict(_ALL, oks=("ok", "last"), okx=("ok", "sum"))
    td.distributed_group_aggregate(t, "grp", aggs, mesh=mesh, capacity_factor=2.5)
    td.distributed_join(t, Table({"grp": np.arange(8, dtype=np.uint32),
                                  "w": np.arange(8, dtype=np.int16)}, device="cpu"),
                        "grp", mesh=mesh, capacity_factor=8.0)
    assert combines == [1]
    assert stacked and set(stacked) == {torch.int64}
