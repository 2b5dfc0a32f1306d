"""The port's table engine (rdst_tpu_torch.table) against the JAX package's
(rdst_tpu.table), one counterpart of every case in ``test_table.py`` and
more.

Both get the same numpy columns, made from a seed; the port's table lives
on the CPU, where its sorts are ``torch.sort`` and no kernel runs.

Tolerances:
  * bit-equal: keys, every integer and bool column, counts, integer sums,
    min/max/first/last, and the whole static-length output of ``filter``
    and of a stable ``sort_by``;
  * float ``sum``: within 1e-9 x sum(|x|) of the group;
  * ``mean``: float32 within rtol 1e-6;
  * unstable sorts: the (key, row) multiset per key.
Slots past a ``group_aggregate``'s count are unspecified and not compared.
An unmatched row of a left join is compared on ``_matched`` and its left
columns; the port zero-fills its right columns, as the reference's
docstring promises (ROADMAP §C).
"""
import numpy as np
import pytest
import torch

from rdst_tpu.table import Table as JTable
from rdst_tpu.table import ops as jops
from rdst_tpu_torch.table import Table
from rdst_tpu_torch.table import ops as tops

torch.set_num_threads(1)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    x = _np(x)
    return x.view(f"u{x.dtype.itemsize}") if x.dtype.kind in "fc" else x


def _both(cols):
    return JTable(cols), Table(cols, device="cpu")


def _same_table(want, got, rows=None):
    assert want.column_names == got.column_names
    for c in want.column_names:
        a, b = _np(want[c]), _np(got[c])
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(_bits(a)[:rows], _bits(b)[:rows], err_msg=c)


@pytest.fixture()
def people():
    rng = np.random.default_rng(1)
    n = 20_000
    return {
        "grp": rng.integers(0, 100, n).astype(np.uint16),
        "score": rng.standard_normal(n).astype(np.float32),
        "weight": rng.integers(0, 1000, n).astype(np.uint32),
        "id": np.arange(n, dtype=np.uint32),
    }


def test_sort_by_single(people):
    jt, tt = _both(people)
    got = tt.sort_by("grp")
    _same_table(jt.sort_by("grp"), got)
    order = np.argsort(people["grp"], kind="stable")
    np.testing.assert_array_equal(_np(got["id"]), people["id"][order])


def test_sort_by_composite_struct_key(people):
    jt, tt = _both(people)
    _same_table(jt.sort_by(["grp", "score"]), tt.sort_by(["grp", "score"]))


def test_sort_by_unstable_keeps_key_row_multiset(people):
    jt, tt = _both(people)
    want, got = jt.sort_by("grp", stable=False), tt.sort_by("grp", stable=False)
    np.testing.assert_array_equal(_np(got["grp"]), _np(want["grp"]))
    assert sorted(zip(_np(got["grp"]).tolist(), _np(got["id"]).tolist())) == \
        sorted(zip(_np(want["grp"]).tolist(), _np(want["id"]).tolist()))


def test_filter(people):
    jt, tt = _both(people)
    mask = people["weight"] > 500
    (want, wc), (got, gc) = jt.filter(mask), tt.filter(mask)
    assert gc.dtype == torch.int32 and int(gc) == int(wc) == mask.sum()
    _same_table(want, got)  # the whole static-length output
    np.testing.assert_array_equal(_np(got["id"])[: int(gc)], people["id"][mask])
    assert tt.filter(torch.from_numpy(mask), return_count=False).n_rows == len(mask)


_ALL_OPS = {
    "total": ("weight", "sum"),
    "cnt": ("weight", "count"),
    "avg": ("weight", "mean"),
    "wmin": ("weight", "min"),
    "wmax": ("weight", "max"),
    "fsum": ("score", "sum"),
    "smin": ("score", "min"),
    "smax": ("score", "max"),
    "sfirst": ("score", "first"),
    "ilast": ("id", "last"),
}


def _same_groups(want, wc, got, gc, cols, by, aggs):
    g = int(wc)
    assert gc.dtype == torch.int32 and int(gc) == g
    assert want.column_names == got.column_names
    keys = by if isinstance(by, list) else [by]
    for name in want.column_names:
        a, b = _np(want[name])[:g], _np(got[name])[:g]
        assert a.dtype == b.dtype, name
        op = aggs[name][1] if name in aggs else None
        if op == "sum" and a.dtype.kind == "f":
            k0 = cols[keys[0]]
            scale = [np.abs(cols[aggs[name][0]][k0 == k]).sum()
                     for k in _np(got[keys[0]])[:g]]
            assert np.all(np.abs(a - b) <= 1e-9 * np.asarray(scale)), name
        elif op == "mean":
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def test_group_aggregate(people):
    jt, tt = _both(people)
    (want, wc), (got, gc) = (t.group_aggregate("grp", _ALL_OPS) for t in (jt, tt))
    _same_groups(want, wc, got, gc, people, "grp", _ALL_OPS)
    keys = np.unique(people["grp"])
    np.testing.assert_array_equal(_np(got["grp"])[: len(keys)], keys)
    w = people["weight"].astype(np.int64)
    assert [int(x) for x in _np(got["total"])[:3]] == \
        [int(w[people["grp"] == k].sum()) for k in keys[:3]]


def test_group_aggregate_composite_and_64bit_columns():
    rng = np.random.default_rng(2)
    n = 5000
    cols = {
        "a": rng.integers(-3, 3, n).astype(np.int8),
        "b": rng.integers(0, 4, n).astype(np.uint64) << np.uint64(40),
        "v": rng.integers(-2**40, 2**40, n),
        "f": rng.standard_normal(n),
        "ok": rng.integers(0, 2, n).astype(bool),
    }
    aggs = {"vs": ("v", "sum"), "vmin": ("v", "min"), "vmax": ("v", "max"),
            "fs": ("f", "sum"), "fm": ("f", "mean"), "fl": ("f", "last"),
            "oks": ("ok", "sum"), "okf": ("ok", "first"), "c": ("v", "count")}
    jt, tt = _both(cols)
    (want, wc), (got, gc) = (t.group_aggregate(["a", "b"], aggs) for t in (jt, tt))
    _same_groups(want, wc, got, gc, cols, ["a", "b"], aggs)


def test_group_aggregate_single_group():
    cols = {"g": np.zeros(1000, np.uint8), "v": np.arange(1000, dtype=np.uint32)}
    jt, tt = _both(cols)
    (want, wc), (got, gc) = (t.group_aggregate("g", {"s": ("v", "sum")}) for t in (jt, tt))
    _same_groups(want, wc, got, gc, cols, "g", {"s": ("v", "sum")})
    assert int(_np(got["s"])[0]) == 1000 * 999 // 2


def test_group_aggregate_empty_and_bad_op():
    cols = {"g": np.zeros(0, np.uint32), "v": np.zeros(0, np.uint32)}
    jt, tt = _both(cols)
    (want, wc), (got, gc) = (t.group_aggregate("g", {"s": ("v", "sum")}) for t in (jt, tt))
    assert int(gc) == int(wc) == 0 and got.n_rows == want.n_rows == 0
    with pytest.raises(ValueError, match="unsupported agg op"):
        tt.group_aggregate("g", {"s": ("v", "median")})


def _join_inputs(rng, nl, nr, key_range):
    right = {"k": rng.permutation(key_range)[:nr].astype(np.uint32),
             "label": rng.integers(0, 1000, nr).astype(np.uint32)}
    left = {"k": rng.integers(0, key_range, nl).astype(np.uint32),
            "x": np.arange(nl, dtype=np.uint32)}
    return left, right


def test_join_inner():
    left, right = _join_inputs(np.random.default_rng(3), 10_000, 500, 2_000)
    (jl, tl), (jr, tr) = _both(left), _both(right)
    (want, wc), (got, gc) = jl.join(jr, on="k"), tl.join(tr, on="k")
    assert int(gc) == int(wc) == got.n_rows
    _same_table(want, got)


def test_join_inner_duplicate_right_keys():
    right = {"k": np.array([1, 1, 2, 5, 5, 5], np.uint32),
             "label": np.array([10, 11, 20, 50, 51, 52], np.uint32)}
    left = {"k": np.array([5, 1, 3, 2, 5], np.uint32),
            "x": np.arange(5, dtype=np.uint32)}
    (jl, tl), (jr, tr) = _both(left), _both(right)
    (want, wc), (got, gc) = jl.join(jr, on="k"), tl.join(tr, on="k")
    assert int(gc) == int(wc) == 9
    _same_table(want, got)
    assert list(zip(_np(got["k"]).tolist(), _np(got["label"]).tolist()))[:3] == \
        [(5, 50), (5, 51), (5, 52)]


def test_join_left_duplicate_right_first_match():
    right = {"k": np.array([7, 7], np.uint32), "v": np.array([1, 2], np.uint32)}
    left = {"k": np.array([7, 8], np.uint32), "x": np.array([0, 1], np.uint32)}
    (jl, tl), (jr, tr) = _both(left), _both(right)
    (want, wc), (got, gc) = (jl.join(jr, on="k", how="left"),
                             tl.join(tr, on="k", how="left"))
    assert int(gc) == int(wc) == 1
    assert _np(got["v"]).tolist() == [1, 0]  # first match; zero-fill
    assert _np(got["_matched"]).tolist() == _np(want["_matched"]).tolist() == [True, False]


def test_join_left_matches_reference_on_matched_rows():
    left, right = _join_inputs(np.random.default_rng(4), 3000, 300, 1000)
    right["x"] = right["label"] * 3  # a right column named like a left one
    (jl, tl), (jr, tr) = _both(left), _both(right)
    (want, wc), (got, gc) = (jl.join(jr, on="k", how="left"),
                             tl.join(tr, on="k", how="left"))
    assert int(gc) == int(wc)
    assert got.column_names == want.column_names == ["k", "x", "label", "x_r", "_matched"]
    m = _np(want["_matched"])
    np.testing.assert_array_equal(_np(got["_matched"]), m)
    for c in ("k", "x"):
        np.testing.assert_array_equal(_np(got[c]), _np(want[c]))
    for c in ("label", "x_r"):
        np.testing.assert_array_equal(_np(got[c])[m], _np(want[c])[m])
        assert not _np(got[c])[~m].any()


def test_join_wide_composite_key():
    rng = np.random.default_rng(5)
    n = 2000
    hi = rng.integers(0, 2**63, n).astype(np.uint64)
    lo2 = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    right = {"a": hi[:500], "b": lo2[:500], "lab": np.arange(500, dtype=np.uint32)}
    left = {"a": hi, "b": lo2, "x": np.arange(n, dtype=np.uint32)}
    (jl, tl), (jr, tr) = _both(left), _both(right)
    (want, wc), (got, gc) = jl.join(jr, on=["a", "b"]), tl.join(tr, on=["a", "b"])
    assert int(gc) == int(wc) == 500
    _same_table(want, got)


def test_join_inner_no_matches():
    right = {"k": np.array([100], np.uint32), "v": np.array([1], np.uint32)}
    left = {"k": np.array([1, 2, 3], np.uint32), "x": np.array([0, 1, 2], np.uint32)}
    (jl, tl), (jr, tr) = _both(left), _both(right)
    (want, wc), (got, gc) = jl.join(jr, on="k"), tl.join(tr, on="k")
    assert int(gc) == int(wc) == 0 and got.n_rows == want.n_rows == 0
    assert got.column_names == want.column_names
    with pytest.raises(ValueError, match="how must be"):
        tl.join(tr, on="k", how="outer")


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("pad", [None, "ones", "random"])
@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_lex_searchsorted(n_words, pad, side):
    """Every query position against the JAX package's, on haystacks with
    runs of equal keys, queries below, inside and above them; with a bound,
    the rows past it are a capacity pad, all-ones words or unsorted ones."""
    import jax.numpy as jnp

    bounded = pad is not None
    rng = np.random.default_rng(10 * n_words + bounded)
    m, nq = 777, 2000
    hay = rng.integers(0, 6, size=(n_words, m)).astype(np.uint32)
    hay[-1, :50] = 0xFFFFFFFF  # the extreme word, in every position
    hay = hay[:, np.lexsort(hay[::-1])]
    q = rng.integers(0, 7, size=(n_words, nq)).astype(np.uint32)
    q[:, :4] = np.array([0, 0xFFFFFFFF, 3, 6], np.uint32)[:, None].T
    bound = 500 if bounded else None
    if pad == "ones":
        hay[:, bound:] = 0xFFFFFFFF
    elif pad == "random":
        hay[:, bound:] = rng.integers(0, 7, size=(n_words, m - bound))
    want = jops._lex_searchsorted(
        [jnp.asarray(w) for w in hay], [jnp.asarray(w) for w in q], side=side,
        bound=None if bound is None else jnp.int32(bound))
    got = tops._lex_searchsorted(
        [torch.from_numpy(w) for w in hay], [torch.from_numpy(w) for w in q],
        side=side, bound=None if bound is None else torch.tensor(bound))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keys = [tuple(r) for r in hay[:, : bound or m].T]
    for i in range(0, nq, 97):  # the contract itself, on a sample
        qi = tuple(q[:, i])
        expect = sum((k < qi) if side == "left" else (k <= qi) for k in keys)
        assert int(got[i]) == expect


@pytest.mark.parametrize("pad", [None, "ones", "random"])
@pytest.mark.parametrize("n_words", [1, 2, 3, 4])
def test_equal_range(n_words, pad):
    """``_equal_range`` (one search and a run end where the key is wider
    than one int64 group) equals the JAX package's two searches."""
    import jax.numpy as jnp

    rng = np.random.default_rng(40 + n_words)
    m, nq = 901, 3000
    hay = rng.integers(0, 4, size=(n_words, m)).astype(np.uint32)
    hay[:, -30:] = 0xFFFFFFFF  # a run at the largest key
    hay = hay[:, np.lexsort(hay[::-1])]
    q = rng.integers(0, 5, size=(n_words, nq)).astype(np.uint32)
    q[:, :2] = np.array([0, 0xFFFFFFFF], np.uint32)[:, None].T
    bound = 600 if pad else None
    if pad == "ones":
        hay[:, bound:] = 0xFFFFFFFF
    elif pad == "random":
        hay[:, bound:] = rng.integers(0, 4, size=(n_words, m - bound))
    jh, jq = [jnp.asarray(w) for w in hay], [jnp.asarray(w) for w in q]
    jb = None if bound is None else jnp.int32(bound)
    lo, hi = tops._equal_range(
        [torch.from_numpy(w) for w in hay], [torch.from_numpy(w) for w in q],
        bound=None if bound is None else torch.tensor(bound, dtype=torch.int32))
    for got, side in ((lo, "left"), (hi, "right")):
        want = jops._lex_searchsorted(jh, jq, side=side, bound=jb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=side)
    assert int((hi > lo).sum()) > nq // 4  # the runs were found


def test_table_devices_and_accessors(people):
    t = Table(people, device="cpu")
    assert t.device.type == "cpu" and t.n_rows == 20_000
    assert repr(t) == ("Table[20000 rows; grp:uint16, score:float32, "
                       "weight:uint32, id:uint32]") == repr(JTable(people))
    assert t.select(["id"]).column_names == ["id"]
    assert list(t.head(3)["id"]) == [0, 1, 2]
    np.testing.assert_array_equal(t.to_numpy()["score"], people["score"])
    t2 = t.with_column("w2", people["weight"] * 2)
    assert t2["w2"].device.type == "cpu" and t2.column_names[-1] == "w2"
    own = torch.arange(3)
    assert Table({"a": own}).column("a") is own  # a tensor stays put
    with pytest.raises(ValueError, match="length mismatch"):
        Table({"a": np.zeros(3), "b": np.zeros(4)}, device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        Table({"a": np.zeros((3, 2))}, device="cpu")
    with pytest.raises(ValueError, match="at least one column"):
        Table({})
    with pytest.raises(ValueError, match="is on meta"):
        Table({"a": own, "b": torch.zeros(3, device="meta")})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Table(people)  # numpy goes to "cuda" by default
