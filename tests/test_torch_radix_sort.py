"""The fused executor's radix passes (ops/radix_sort.py, kernel B8).

* B8's plain pass and the whole plain sort against numpy's stable sorts,
  at key planes of mixed widths (1-8 bytes), with and without a payload;
* ``_kernel_model`` runs the decomposition of ``csrc/radix_pass.cu`` tile by
  tile on the CPU (warp-striped loads, the per-warp ranking that
  ballots give, the warps' offsets, the look-back over the
  earlier tiles' flags in an order other than the tiles', the staging in
  digit order and the destinations), so its index arithmetic is checked
  here before the card, bit for bit against the plain pass;
* the route ``fused_sort`` takes by shape, and its output on the radix
  passes against the network's on the same rows.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rdst_tpu_torch import config
from rdst_tpu_torch.ops import fused_sort as fs
from rdst_tpu_torch.ops import radix_sort as rs
from rdst_tpu_torch.parallel import shuffle as sh

torch.set_num_threads(1)

U8, U16, U32 = np.uint8, np.uint16, np.uint32
_TORCH = {U8: torch.uint8, U16: torch.uint16, U32: torch.uint32}


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(tensors):
    return [t.numpy() for t in tensors]


def _planes(rng, n, dtypes, high=None):
    out = []
    for dt in dtypes:
        top = np.iinfo(dt).max + 1 if high is None else min(high, np.iinfo(dt).max + 1)
        out.append(rng.integers(0, top, size=n, dtype=np.uint64).astype(dt))
    return out


def _order(keys):
    """The stable order of rows by key planes (most significant first)."""
    return np.lexsort([k.astype(np.uint64) for k in keys[::-1]])


def _digit(keys, byte):
    j, shift = rs._digit([_TORCH[k.dtype.type] for k in keys], byte)
    return (keys[j].astype(np.uint64) >> shift) & 0xFF


# -- the plain pass and the plain sort -----------------------------------------

KEY_SHAPES = [(U32,), (U32, U32), (U16, U32), (U8, U16, U32), (U8,), (U16,),
              (U32, U16), (U8, U8), (U16, U16, U16, U8), (U8,) * 8]


@pytest.mark.parametrize("dtypes", KEY_SHAPES)
def test_plain_pass_is_a_stable_sort_by_one_byte(dtypes):
    rng = np.random.default_rng(len(dtypes))
    n = 3001
    keys = _planes(rng, n, dtypes)
    pay = np.arange(n, dtype=U32)
    nbytes = sum(np.dtype(d).itemsize for d in dtypes)
    for byte in range(nbytes):
        before = rs.RADIX_PASS.plain_calls
        got = _np(rs.radix_pass_plain(_t(keys + [pay]), len(keys), byte))
        assert rs.RADIX_PASS.plain_calls == before + 1
        order = np.argsort(_digit(keys, byte), kind="stable")
        for g, w in zip(got, keys + [pay]):
            np.testing.assert_array_equal(g, w[order])


@pytest.mark.parametrize("dtypes", KEY_SHAPES)
@pytest.mark.parametrize("payload", [None, U8, U16, U32, np.float32])
def test_plain_sort_matches_lexsort(dtypes, payload):
    rng = np.random.default_rng(7 * len(dtypes) + (0 if payload is None else 1))
    n = 2 * rs.TILE + 77
    keys = _planes(rng, n, dtypes, high=None if len(dtypes) > 1 else 1 << 12)
    pays = []
    if payload is np.float32:
        pays = [rng.standard_normal(n).astype(np.float32)]
    elif payload is not None:
        pays = _planes(rng, n, (payload,))
    tk = _t(keys)
    tp = [p.view(torch.uint32) if p.dtype == torch.float32 else p for p in _t(pays)]
    ok, op = rs.radix_sort(tk, tp)
    order = _order(keys)
    for g, w in zip(_np(ok), keys):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w[order])
    for g, w in zip(op, pays):
        got = g.view(torch.float32).numpy() if payload is np.float32 else g.numpy()
        np.testing.assert_array_equal(got, w[order])


@pytest.mark.parametrize("n", [1, 2, rs.TILE - 1, rs.TILE, rs.TILE + 1])
def test_plain_sort_edges(n):
    rng = np.random.default_rng(n)
    keys = _planes(rng, n, (U32, U32), high=3)  # ties everywhere
    pay = np.arange(n, dtype=U32)
    ok, op = rs.radix_sort(_t(keys), _t([pay]))
    order = _order(keys)
    np.testing.assert_array_equal(op[0].numpy(), pay[order])
    for g, w in zip(_np(ok), keys):
        np.testing.assert_array_equal(g, w[order])


def test_inputs_are_not_written():
    rng = np.random.default_rng(3)
    keys = _planes(rng, 5000, (U16, U32))
    tk = _t(keys)
    rs.radix_sort(tk, [])
    for t, k in zip(tk, keys):
        np.testing.assert_array_equal(t.numpy(), k)


def test_pass_refuses_bad_shapes():
    """The plain pass and the kernel wrapper refuse the same shapes, before
    any launch."""
    u32 = torch.zeros(8, dtype=torch.uint32)

    def wrapper(planes, n_keys, byte):
        return rs.radix_pass(planes, [torch.empty_like(p) for p in planes], n_keys,
                             byte, torch.zeros(256, dtype=torch.int64),
                             rs.pass_scratch(8, "cpu"))

    before = rs.RADIX_PASS.launches
    for fn in (rs.radix_pass_plain, wrapper):
        with pytest.raises(ValueError):
            fn([u32, u32, u32], 1, 0)  # two payload planes
        with pytest.raises(ValueError):
            fn([u32, u32[:4]], 1, 0)  # lengths differ
        with pytest.raises(ValueError):
            fn([u32, u32, torch.zeros(8, dtype=torch.uint8)], 3, 0)  # 9 key bytes
        with pytest.raises(ValueError):
            fn([u32], 1, 4)  # byte beyond the key
        with pytest.raises(ValueError):
            fn([torch.zeros(8, dtype=torch.int32)], 1, 0)  # not unsigned
    assert rs.RADIX_PASS.launches == before


# -- the kernel's decomposition, tile by tile ------------------------------------


def _source_constants():
    src = (Path(rs.__file__).resolve().parent.parent / "csrc" / "radix_pass.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    items = int(re.search(r"constexpr int kItems = (\d+);", src).group(1))
    return threads, items


def test_tile_mirrors_the_source():
    threads, items = _source_constants()
    assert threads == 256 and rs.TILE == threads * items


def _kernel_model(planes, n_keys, byte, counts, order_rng):
    """``radix_pass_kernel`` tile by tile: rows of warp w, item i, lane l at
    tile * TILE + w * 32 * kItems + i * 32 + l; the look-back runs after
    every tile has published its aggregate, in the order ``order_rng``
    draws, so it walks over aggregates as well as inclusive prefixes."""
    threads, items = _source_constants()
    warps = threads // 32
    tile_rows = threads * items
    n = planes[0].shape[0]
    j, shift = rs._digit([_TORCH[p.dtype.type] for p in planes[:n_keys]], byte)
    digits = ((planes[j].astype(np.uint64) >> shift) & 0xFF).astype(np.int64)
    tiles = -(-n // tile_rows)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flags = np.zeros((tiles, 256), np.int64)  # (status, count): 1 agg, 2 incl
    status = np.zeros((tiles, 256), np.int64)
    local = []
    for t in range(tiles):
        warp_rows = np.zeros((warps, 256), np.int64)
        pos = {}
        for w in range(warps):
            for i in range(items):
                rows = t * tile_rows + w * 32 * items + i * 32 + np.arange(32)
                valid = rows < n
                d = np.where(valid, digits[np.minimum(rows, n - 1)], -1)
                for lane in range(32):
                    if not valid[lane]:
                        continue
                    peers = (d == d[lane])
                    rank = warp_rows[w, d[lane]] + int(peers[:lane].sum())
                    pos[rows[lane]] = (w, d[lane], rank)
                for dv in set(d[valid].tolist()):
                    warp_rows[w, dv] += int((d == dv).sum())
        count = warp_rows.sum(0)
        warp_off = np.cumsum(warp_rows, 0) - warp_rows
        start = np.cumsum(count) - count
        flags[t] = count
        status[t] = 2 if t == 0 else 1
        local.append((pos, warp_off, start, count))
    off = np.zeros((tiles, 256), np.int64)
    for t in order_rng.permutation(tiles):
        before = np.zeros(256, np.int64)
        for dv in range(256):
            for jt in range(t - 1, -1, -1):
                before[dv] += flags[jt, dv]
                if status[jt, dv] == 2:
                    break
        if t > 0:
            flags[t] = before + local[t][3]
            status[t] = 2
        off[t] = base + before - local[t][2]
    outs = [np.empty_like(p) for p in planes]
    for t in range(tiles):
        pos, warp_off, start, _ = local[t]
        tile_n = min(tile_rows, n - t * tile_rows)
        stage_rows = np.empty(tile_n, np.int64)
        for r, (w, dv, rank) in pos.items():
            stage_rows[start[dv] + warp_off[w, dv] + rank] = r
        for p_ in range(tile_n):
            r = stage_rows[p_]
            dest = off[t, digits[r]] + p_
            for q, plane in enumerate(planes):
                outs[q][dest] = plane[r]
    return outs


@pytest.mark.parametrize("dtypes,n,high", [
    ((U32, U32), 3 * 4096 + 1001, None),
    ((U16, U32), 2 * 4096 + 5, 4),          # ties across tiles
    ((U8, U16, U32), 4096, None),
    ((U8,), 3 * 4096 - 1, None),
])
def test_kernel_model_matches_plain(dtypes, n, high):
    rng = np.random.default_rng(n)
    keys = _planes(rng, n, dtypes, high=high)
    pay = rng.integers(0, 2**16, size=n).astype(U16)
    planes = keys + [pay]
    nbytes = sum(np.dtype(d).itemsize for d in dtypes)
    for byte in sorted({0, nbytes - 1, nbytes // 2}):
        counts = np.bincount(_digit(keys, byte).astype(np.int64), minlength=256)
        got = _kernel_model(planes, len(keys), byte, counts, rng)
        want = _np(rs.radix_pass_plain(_t(planes), len(keys), byte))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_hist_words_hold_the_key_bytes():
    """B1's words: key byte l is level l, for every plane layout."""
    rng = np.random.default_rng(5)
    for dtypes in KEY_SHAPES:
        keys = _planes(rng, 257, dtypes)
        words = _np(rs.hist_words(_t(keys)))
        nbytes = sum(np.dtype(d).itemsize for d in dtypes)
        assert len(words) == -(-nbytes // 4)
        for byte in range(nbytes):
            level = (words[len(words) - 1 - byte // 4].astype(np.uint64)
                     >> (8 * (byte % 4))) & 0xFF
            np.testing.assert_array_equal(level, _digit(keys, byte))


def test_kernel_wrapper_refuses_cpu_tensors():
    u32 = torch.zeros(8, dtype=torch.uint32)
    before = rs.RADIX_PASS.launches
    with pytest.raises(ValueError):
        rs.radix_pass([u32], [torch.empty_like(u32)], 1, 0,
                      torch.zeros(256, dtype=torch.int64), rs.pass_scratch(8, "cpu"))
    assert rs.RADIX_PASS.launches == before


# -- the route fused_sort takes, by shape -----------------------------------------


@pytest.mark.parametrize("keys,pays,kw,radix", [
    ((U32, U32), (), {}, True),
    ((U32, U32), (U32,), {}, True),
    ((U8, U16, U32), (U16,), {}, True),
    ((U32, U32, U8), (), {}, False),            # 9 key bytes
    ((U32,), (U32, U32), {}, False),            # two payload planes
    ((U32, U32), (), {"row": 256}, True),       # the network's own knobs
    ((U32, U32), (), {"block": 1024}, True),    # do not choose the route
])
def test_route_by_shape(keys, pays, kw, radix, monkeypatch):
    monkeypatch.setattr(config, "fused_min_piece", 1024)
    rng = np.random.default_rng(11)
    n = 4096 + 3
    k = _planes(rng, n, keys)
    p = _planes(rng, n, pays)
    assert rs.takes(_t(k), _t(p)) == radix
    before = rs.RADIX_PASS.plain_calls, fs.TAIL.plain_calls
    ok, op = fs.fused_sort(_t(k), _t(p), stable=True, **kw)
    took_radix = rs.RADIX_PASS.plain_calls > before[0]
    assert took_radix == radix
    assert (fs.TAIL.plain_calls > before[1]) == (not radix)
    assert fs.last_route == ("B8" if radix else "B2/B3")
    order = _order(k)
    for g, w in zip(_np(ok) + _np(op), k + p):
        np.testing.assert_array_equal(g, w[order])


def test_gate_edges():
    u32 = torch.zeros(3, dtype=torch.uint32)
    u16 = torch.zeros(3, dtype=torch.uint16)
    u8 = torch.zeros(3, dtype=torch.uint8)
    f32 = torch.zeros(3, dtype=torch.float32)
    i64 = torch.zeros(3, dtype=torch.int64)
    assert rs.takes([u32, u32])
    assert rs.takes([u32, u16, u16])                 # 8 bytes
    assert not rs.takes([u32, u16, u16, u8])         # 9 bytes
    assert rs.takes([u8], [f32])
    assert not rs.takes([u32], [i64])                # an 8-byte payload
    assert not rs.takes([u32], [u8, u8])
    assert rs.takes([u32[:1]])                       # one row
    assert not rs.takes([u32[:0]])                   # none


class _Huge:
    """A stand-in plane of MAX_ROWS + 1 rows: ``takes`` reads shapes only."""
    shape = (rs.MAX_ROWS + 1,)
    dtype = torch.uint32


def test_gate_row_limit():
    assert not rs.takes([_Huge()])


@pytest.mark.parametrize("nk,npay,stable,n", [
    (1, 0, False, 1 << 12), (2, 1, False, 1 << 12), (1, 1, True, 1 << 13),
    (2, 0, True, 5000), (2, 1, True, 4429), (1, 1, False, 9000),
])
def test_output_unchanged_against_the_network(nk, npay, stable, n, monkeypatch):
    """Every shape the executor took before now on the radix passes: the
    keys equal the network's, stable payloads too, unstable ones as the same
    (key, payload) multiset."""
    monkeypatch.setattr(config, "fused_min_piece", 1024)
    rng = np.random.default_rng(n + nk)
    keys = _planes(rng, n, (U32,) * nk, high=1 << 10)
    pays = _planes(rng, n, (U32,) * npay)
    rk, rp = fs.fused_sort(_t(keys), _t(pays), stable=stable)
    monkeypatch.setattr(rs, "takes", lambda *a, **k: False)  # the network
    nk_, np_ = fs.fused_sort(_t(keys), _t(pays), stable=stable, row=256, block=1024)
    for a, b in zip(_np(rk), _np(nk_)):
        np.testing.assert_array_equal(a, b)
    if stable:
        for a, b in zip(_np(rp), _np(np_)):
            np.testing.assert_array_equal(a, b)
    elif npay:
        got = sorted(zip(*[x.tolist() for x in _np(rk) + _np(rp)]))
        want = sorted(zip(*[x.tolist() for x in _np(nk_) + _np(np_)]))
        assert got == want


def test_narrow_and_float_planes_keep_their_dtypes():
    rng = np.random.default_rng(9)
    n = 5000
    k16 = rng.integers(0, 2**16, size=n).astype(np.uint16)
    pf = rng.standard_normal(n).astype(np.float32)
    out_k, out_p = fs.fused_sort(_t([k16]), _t([pf]))
    assert out_k[0].dtype == torch.uint16 and out_p[0].dtype == torch.float32
    order = np.argsort(k16, kind="stable")
    np.testing.assert_array_equal(out_k[0].numpy(), k16[order])
    np.testing.assert_array_equal(out_p[0].numpy(), pf[order])


def test_radix_span_is_a_child_of_fused_sort():
    rng = np.random.default_rng(4)
    keys = _t(_planes(rng, 3000, (U32, U32)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fs.fused_sort(keys)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("rdst.")]
    assert sorted(names) == ["rdst.fused_sort", "rdst.fused_sort.radix"]


@pytest.mark.parametrize("planes,n_keys,route", [
    ((U32, U32), 2, "B8"),
    ((U32, U32, U32), 2, "B8"),
    ((U32, U32, U32, U32), 2, "B2/B3"),
])
def test_shuffle_routes_name_b8(planes, n_keys, route, monkeypatch):
    monkeypatch.setattr(config, "fused_min_elems", 2048)
    rng = np.random.default_rng(2)
    n = 3000
    arrays = _planes(rng, n, planes)
    sh.SORT_ROUTES.clear()
    out = sh._local_sort(_t(arrays), n_keys, True)
    assert dict(sh.SORT_ROUTES) == {(len(planes), n, route): 1}
    order = _order(arrays[:n_keys])
    for g, w in zip(_np(out), arrays):
        np.testing.assert_array_equal(g, w[order])
