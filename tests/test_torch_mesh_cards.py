"""The port's mesh over several cards of one process
(``make_mesh(..., devices=...)``) against the JAX package's 8-device CPU
mesh, and against its own one-card mesh.

The JAX side runs ``rdst_tpu.parallel.make_mesh(8)`` (and
``make_mesh_2d(2, 4)``) on the virtual 8-device CPU mesh of
``conftest.py``, as its own tests run it; the port runs ``make_mesh(8,
devices=["cpu"] * K)`` for K in {1, 2, 4, 8}: the cards' grouping through
the exchange's plain per-card form.  Both get the same numpy inputs, made
from a seed, 2^10 rows a shard.

Tolerances, ROADMAP's rule: keys bit-equal; stable payloads bit-equal;
unstable runs the same (key, payload) multiset on every shard; counts,
group and match counts equal.  The table operators' columns are held as
``tests/test_torch_dtable.py`` holds them (a float mean within rtol 1e-6).
The convention checked throughout: on K > 1 cards each output plane is a
list of K blocks (and each table operator returns one Table a card), and
the blocks concatenated in card order are the one-card result.  The card
tests (one card, K streams) are in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rdst_tpu import parallel as jp
from rdst_tpu.parallel import dtable as jd
from rdst_tpu.table import Table as JTable
from rdst_tpu_torch import parallel as tp
from rdst_tpu_torch.parallel import dtable as td
from rdst_tpu_torch.parallel import mesh as tmesh
from rdst_tpu_torch.parallel import remote_dma as rd
from rdst_tpu_torch.table import Table
from test_torch_dtable import _same as _same_table
from test_torch_exchange import _kernel_model
from test_torch_shuffle import _assert_same, _deep_hot_input, _input, _u64_planes

torch.set_num_threads(1)

KS = [1, 2, 4, 8]
N = 1 << 13  # 2^10 rows a shard on 8 shards
_JAX = {}  # the JAX package's result of each case, computed once


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def _cards(K):
    return ["cpu"] * K


def _joined(plane, K):
    """An output plane of a K-card mesh as one tensor: K blocks, each of
    the same length, concatenated in card order."""
    if K == 1:
        assert isinstance(plane, torch.Tensor)
        return plane
    assert isinstance(plane, list) and len(plane) == K
    assert len({int(b.shape[0]) for b in plane}) == 1
    return torch.cat(plane)


def _sort_joined(out, K):
    return ([_joined(p, K) for p in out[0]], [_joined(p, K) for p in out[1]],
            *out[2:])


def _table_joined(out, K):
    t, n = out
    if K == 1:
        assert isinstance(t, Table)
        return t, n
    assert isinstance(t, list) and len(t) == K
    return Table({c: torch.cat([x[c] for x in t]) for c in t[0].column_names}), n


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("dist_,stable", [
    ("u64", True), ("u64", False), ("hot_key", True), ("hot_key", False),
    ("hot_bucket", True), ("hot_bucket", False),
])
def test_distributed_sort_matches_jax(dist_, stable, K):
    """Uniform u64 keys, one key on 3/4 of the rows (split by exact rank),
    and a hot multi-key bucket that refines."""
    rng = np.random.default_rng(sum(map(ord, dist_)) + stable)
    words, cf = _input(dist_, rng, N)
    pay = np.arange(N, dtype=np.uint32)
    kw = dict(capacity_factor=cf, stable=stable)
    jout = _jax(("sort", dist_, stable),
                lambda: jp.distributed_sort(words, [pay], mesh=jp.make_mesh(8), **kw))
    tout = tp.distributed_sort(words, [pay], mesh=tp.make_mesh(8, devices=_cards(K)), **kw)
    _assert_same(jout, _sort_joined(tout, K), len(words), stable)


@pytest.mark.parametrize("K", KS)
def test_overlapped_exchange_matches_jax(K):
    rng = np.random.default_rng(41)
    words = _u64_planes(rng.integers(0, 2**64, size=N, dtype=np.uint64))
    pay = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    kw = dict(stable=True, overlap_exchange=True)
    jout = _jax(("overlap",), lambda: jp.distributed_sort(words, [pay], mesh=jp.make_mesh(8),
                                                          **kw))
    tout = tp.distributed_sort(words, [pay], mesh=tp.make_mesh(8, devices=_cards(K)), **kw)
    _assert_same(jout, _sort_joined(tout, K), 2, True)


@pytest.mark.parametrize("K", KS)
def test_partition_and_copartition_match_jax(K):
    """The partition of ``split_uniform=False, return_partition=True`` is
    replicated on card 0; ``partition_exchange`` of a second dataset under
    it lands the same shards as the JAX package's."""
    rng = np.random.default_rng(42)
    fact = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    other = np.concatenate([fact[: N // 2], rng.integers(0, 2**32, N // 2, dtype=np.uint32)])
    pay = np.arange(N, dtype=np.uint32)
    kw = dict(capacity_factor=3.0, stable=True, split_uniform=False, return_partition=True)
    jm = jp.make_mesh(8)
    jout = _jax(("part",), lambda: jp.distributed_sort([fact], [pay], mesh=jm, **kw))
    mesh = tp.make_mesh(8, devices=_cards(K))
    tout = tp.distributed_sort([fact], [pay], mesh=mesh, **kw)
    _assert_same(jout[:3], _sort_joined(tout[:3], K), 1, True)
    for a, b in zip(jout[3], tout[3]):
        np.testing.assert_array_equal(b.numpy().astype(np.int64), np.asarray(a).astype(np.int64))
    opay = np.arange(N, dtype=np.uint32) * 3
    jx = _jax(("copart",), lambda: jp.partition_exchange(
        [other], [opay], jout[3], mesh=jm, capacity_factor=3.0, stable=True))
    tx = tp.partition_exchange([other], [opay], tout[3], mesh=mesh, capacity_factor=3.0,
                               stable=True)
    _assert_same(jx, _sort_joined(tx, K), 1, True)


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("overlap", [False, True])
def test_mesh_2d_matches_jax(K, overlap):
    """``make_mesh_2d(2, 4, devices=[...] * K)``: K = 2 puts each host row
    on one card (the chip exchange stays on a card, the host exchange spans
    two), K = 4 and 8 split the rows too."""
    rng = np.random.default_rng(43)
    words = _u64_planes(rng.integers(0, 2**16, size=N, dtype=np.uint64))
    pay = np.arange(N, dtype=np.uint32)
    kw = dict(stable=True, overlap_exchange=overlap)
    jm2 = jp.make_mesh_2d(2, 4)
    jout = _jax(("2d", overlap), lambda: jp.distributed_sort(
        words, [pay], mesh=jm2, axis=jm2.axis_names, **kw))
    tm2 = tp.make_mesh_2d(2, 4, devices=_cards(K))
    tout = tp.distributed_sort(words, [pay], mesh=tm2, axis=tm2.axis_names, **kw)
    _assert_same(jout, _sort_joined(tout, K), 2, True)


@pytest.mark.parametrize("K", KS)
def test_overflow_counts_and_auto_retry_match_jax(K):
    """Deep skew past the capacity: the same counts as the JAX package's,
    ``gather_valid`` raises on the per-card planes; ``distributed_sort_auto``
    reaches the JAX package's capacity, bit-equal."""
    rng = np.random.default_rng(44)
    words = _u64_planes(_deep_hot_input(rng, N))
    pay = np.arange(N, dtype=np.uint32)
    mesh = tp.make_mesh(8, devices=_cards(K))
    jout = _jax(("overflow",), lambda: jp.distributed_sort(words, mesh=jp.make_mesh(8),
                                                           capacity_factor=1.1))
    tout = tp.distributed_sort(words, mesh=mesh, capacity_factor=1.1)
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    with pytest.raises(OverflowError):
        tp.gather_valid(tout[0], tout[2])
    kw = dict(capacity_factor=1.1, max_capacity_factor=16.0, stable=True)
    jauto = _jax(("auto",), lambda: jp.distributed_sort_auto(words, [pay],
                                                             mesh=jp.make_mesh(8), **kw))
    tauto = tp.distributed_sort_auto(words, [pay], mesh=mesh, **kw)
    assert _joined(tauto[0][0], K).shape == jauto[0][0].shape
    _assert_same(jauto, _sort_joined(tauto, K), 2, True)
    got = tp.gather_valid(tauto[0] + tauto[1], tauto[2])
    order = np.lexsort(words[::-1])
    np.testing.assert_array_equal(got[-1], pay[order])


@pytest.fixture(scope="module")
def sales():
    rng = np.random.default_rng(45)
    n = N
    return {
        "key": rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32),
        "grp": rng.integers(0, 64, n).astype(np.uint32),
        "qty": rng.integers(1, 50, n).astype(np.uint32),
        "price": rng.integers(-10**6, 10**6, n).astype(np.int64),
    }


@pytest.fixture(scope="module")
def dim():
    rng = np.random.default_rng(46)
    return {"grp": np.arange(64, dtype=np.uint32).repeat(2),
            "w": rng.integers(0, 100, 128).astype(np.int32)}


_OPS = {
    "sort_table": ("distributed_sort_table", lambda s, d: ([s], ("key",), {})),
    "filter": ("distributed_filter", lambda s, d: ([s], (s["qty"] > 20,), {})),
    "aggregate_range": ("distributed_group_aggregate", lambda s, d: (
        [s], ("grp", {"sum_qty": ("qty", "sum"), "mx": ("price", "max"),
                      "avg": ("qty", "mean"), "n": (None, "count")}), {})),
    "aggregate_hash": ("distributed_group_aggregate", lambda s, d: (
        [s], ("grp", {"sum_qty": ("qty", "sum"), "mn": ("price", "min")}),
        {"partition": "hash"})),
    "join_inner": ("distributed_join", lambda s, d: (
        [s, d], ("grp",), {"join_capacity_factor": 2.5})),
    "join_left_hash": ("distributed_join", lambda s, d: (
        [s, d], ("grp",), {"how": "left", "partition": "hash"})),
}


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("op", list(_OPS))
def test_dtable_operators_match_jax(sales, dim, op, K):
    """The four table operators (the aggregate and the join in both
    partitions): one Table a card, concatenated equal to the JAX package's
    output column for column, with the same counts."""
    name, args = _OPS[op]
    tables, pos, kw = args(sales, dim)
    want = _jax(("dtable", op), lambda: getattr(jd, name)(
        *[JTable(t) for t in tables], *pos, mesh=jp.make_mesh(8), **kw))
    mesh = tp.make_mesh(8, devices=_cards(K))
    got = getattr(td, name)(*[Table(t, device="cpu") for t in tables], *pos, mesh=mesh, **kw)
    if K > 1:
        assert all(t.device == torch.device("cpu") for t in got[0])
    _same_table(want, _table_joined(got, K), means=("avg",))


@pytest.mark.parametrize("K", [2, 4, 8])
def test_per_card_outputs_concatenate_to_the_one_card_result(sales, K):
    """The convention itself, against the port's own one-card mesh: each
    plane K blocks of L_c x capacity rows, a 2-axis output likewise, a
    sort's per-card output taken back as its input, and the operators'
    per-card tables (each on its card) concatenated; counts one tensor."""
    rng = np.random.default_rng(47)
    words = _u64_planes(rng.integers(0, 2**64, size=N, dtype=np.uint64))
    one, many = tp.make_mesh(8, device="cpu"), tp.make_mesh(8, devices=_cards(K))
    ref = tp.distributed_sort(words, mesh=one, stable=True)
    got = tp.distributed_sort(words, mesh=many, stable=True)
    cap = int(ref[0][0].shape[0]) // 8
    for a, b in zip(ref[0], got[0]):
        assert [int(x.shape[0]) for x in b] == [cap * 8 // K] * K
        assert torch.equal(torch.cat(b), a)
    assert isinstance(got[2], torch.Tensor) and torch.equal(got[2], ref[2])
    # a per-card output (pads included) is an input of the same form
    again = tp.distributed_sort(got[0], mesh=many, stable=True, capacity_factor=2.0)
    dense = tp.gather_valid(again[0], again[2])
    fed = [torch.cat(b).numpy() for b in got[0]]
    order = np.lexsort(fed[::-1])
    for d, w in zip(dense, fed):
        np.testing.assert_array_equal(d, w[order])
    t = Table(sales, device="cpu")
    for fn in (lambda m: td.distributed_sort_table(t, "key", mesh=m),
               lambda m: td.distributed_group_aggregate(t, "grp", {"s": ("qty", "sum")},
                                                        mesh=m)):
        (rt_, rn), (gt, gn) = fn(one), fn(many)
        assert len(gt) == K
        for c in rt_.column_names:
            assert torch.equal(torch.cat([x[c] for x in gt]), rt_[c])
        assert torch.equal(rn, gn)
    # the tables of a per-card output taken back in
    (st, _), (again_t, _) = (td.distributed_sort_table(t, "key", mesh=many),
                             td.distributed_sort_table(t, "key", mesh=one))
    def big(t):
        return t["qty"].to(torch.int64) > 10

    (back, _) = td.distributed_filter(st, [big(x) for x in st], mesh=many)
    (back1, _) = td.distributed_filter(again_t, big(again_t), mesh=one)
    for c in back1.column_names:
        assert torch.equal(torch.cat([x[c] for x in back]), back1[c])


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("case", ["random", "edges", "overflow"])
def test_column_blocks_are_the_square_exchange(K, case):
    """The multi-card exchange's K launches, each on its card's (S, R_c)
    column block, against the square exchange: receive buffers (pads
    included), demand and arrivals, concatenated card by card, equal; each
    block as the kernel walks it (``_kernel_model``) equals its plain
    block; and each card's pointer table holds exactly the senders' planes
    and that card's own receive buffers."""
    rng = np.random.default_rng(K * 10 + len(case))
    S = R = 8
    n_local, k = 1 << 10, 2
    sm = rng.integers(0, 2 * n_local // R, size=(S, R))
    if case == "edges":
        sm[0, 1], sm[:, 3], sm[5, :] = 0, 0, 0
    elif case == "overflow":
        sm[:, 2] = n_local // 2
    sm = np.minimum(sm, n_local // R).astype(np.int64)
    offs = np.cumsum(sm, 1) - sm
    cap = int(sm.sum(0).max()) + 3 if case != "overflow" else n_local // 2 + 1
    mem = [[rng.integers(0, 2**32, size=n_local, dtype=np.uint32) for _ in range(k)]
           for _ in range(S)]
    planes = [[torch.from_numpy(p) for p in ps] for ps in mem]
    o = [torch.from_numpy(x) for x in offs]
    z = [torch.from_numpy(x) for x in sm]
    cards = [d // (R // K) for d in range(R)]
    before = rd.EXCHANGE.plain_calls
    blocks = rd.remote_dma_exchange_cards(planes, o, z, cap, cards, cards, _cards(K))
    assert rd.EXCHANGE.plain_calls - before == K * S * k  # one plain run a card
    assert len(blocks) == K
    recv, demand, arrived = rd.remote_dma_exchange_plain(planes, o, z, cap)
    for j in range(k):
        assert torch.equal(torch.cat([b[0][j] for b in blocks]), recv[j])
    assert torch.equal(torch.cat([b[1] for b in blocks]), demand)
    assert torch.equal(torch.cat([b[2] for b in blocks], 1), arrived)
    for (c, cols), (brecv, _, barr) in zip(rd._blocks(cards), blocks):
        out, writes, arr = _kernel_model(mem, 0, offs[:, cols], sm[:, cols], cap, 256)
        for j in range(k):
            np.testing.assert_array_equal(out[j], brecv[j].numpy())
            assert (writes[j] == 1).all()  # every receive word written once
        np.testing.assert_array_equal(arr, barr.numpy())
        table = rd._pointer_table(planes, brecv, cap)
        senders = [planes[s][j].data_ptr() for j in range(k) for s in range(S)]
        mine = [b.data_ptr() + 4 * cap * r for b in brecv for r in range(len(cols))]
        assert table == senders + mine
        others = {b.data_ptr() for cc, (r2, _, _) in enumerate(blocks) if cc != c for b in r2}
        assert not others & set(table)


def test_cards_of_a_mesh():
    """Card c holds the contiguous flat shards [c D/K, (c+1) D/K); on CPU
    cards there are no streams and every card reads the replicated
    tensors themselves; ``each`` walks the shards card by card."""
    m = tp.make_mesh(8, devices=_cards(4))
    assert [m.card_of(s) for s in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert m.device == torch.device("cpu") and m.per_card == 2
    assert [m.device_of(s) for s in range(8)] == [torch.device("cpu")] * 8
    assert m.stream_of(2) is None and m.streams is None
    assert list(m.each()) == [(i, i // 2) for i in range(8)]
    x = torch.arange(3)
    assert all(r[0] is x for r in m.replicas(x))
    m2 = tp.make_mesh_2d(2, 4, devices=_cards(2))
    assert [m2.card_of(s) for s in range(8)] == [0] * 4 + [1] * 4  # a host row a card
    one = tp.make_mesh(8, device="cpu")
    assert one.devices == [torch.device("cpu")] and one.per_card == 8


@pytest.mark.parametrize("case", ["not_dividing", "not_dividing_2d", "mixed", "meta",
                                  "empty", "processes", "nccl_card"])
def test_mesh_errors_raise_before_any_work(monkeypatch, case):
    """K not dividing the shards, mixed or unsupported device types, no
    card, and under NCCL a first card that is not the current CUDA device
    all raise from the constructor.  ``devices`` while a process group of
    several ranks is up places the rank's block of shards on its cards."""
    if case in ("processes", "nccl_card"):  # rank 1 of a 2-rank group
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
        monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
        monkeypatch.setattr(dist, "get_backend",
                            lambda *a: "gloo" if case == "processes" else "nccl")
    if case == "not_dividing":
        with pytest.raises(ValueError, match="evenly over 3 cards"):
            tp.make_mesh(8, devices=_cards(3))
    elif case == "not_dividing_2d":
        with pytest.raises(ValueError):
            tp.make_mesh_2d(2, 4, devices=_cards(3))
    elif case == "mixed":
        with pytest.raises(ValueError, match="all CUDA or all CPU"):
            tp.make_mesh(8, devices=["cpu", "cuda:0"])
    elif case == "meta":
        with pytest.raises(ValueError):
            tp.make_mesh(8, devices=["meta", "meta"])
    elif case == "empty":
        with pytest.raises(ValueError):
            tp.make_mesh(8, devices=[])
    elif case == "processes":
        m = tp.make_mesh(8, devices=_cards(2))
        assert m.processes and m.world == 2 and list(m.shards) == [4, 5, 6, 7]
        assert m.per_card == 2 and [m.card_of(s) for s in m.shards] == [0, 0, 1, 1]
        assert list(m.each()) == [(0, 0), (1, 0), (2, 1), (3, 1)]
        assert m.comm_device == torch.device("cpu") and m.owner(3) == 0
        m2 = tp.make_mesh_2d(2, 4, devices=_cards(4))  # one host row, a chip a card
        assert list(m2.shards) == [4, 5, 6, 7] and m2.per_card == 1
        assert [m2.card_of(s) for s in m2.shards] == [0, 1, 2, 3]
        assert list(m2.each()) == [(i, i) for i in range(4)]
        assert m2.spans(m2.groups("host")) and not m2.spans(m2.groups("chip"))
        with pytest.raises(ValueError, match="evenly over 8 cards"):
            tp.make_mesh(8, devices=_cards(8))  # 4 shards a rank
        assert tp.make_mesh(8, device="cpu").processes  # one card a rank still works
    else:  # NCCL: the rank's first card carries the communicator
        with pytest.raises(ValueError, match="current CUDA device"):
            tp.make_mesh(8, devices=_cards(2))
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        with pytest.raises(ValueError, match="current CUDA device"):
            tmesh.Mesh((8,), ("shard",), torch.device("cuda", 1))
        m = tmesh.Mesh((8,), ("shard",), torch.device("cuda", 0))
        assert m.comm_device == torch.device("cuda", 0) and list(m.shards) == [4, 5, 6, 7]


def test_per_card_input_blocks_are_checked():
    """A per-card input has one block a card, each holding its shards' rows."""
    mesh = tp.make_mesh(8, devices=_cards(2))
    w = torch.arange(64, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        tp.distributed_sort([[w[:32], w[32:], w[:0]]], mesh=mesh)  # three blocks
    with pytest.raises(ValueError):
        tp.distributed_sort([[w[:40], w[40:]]], mesh=mesh)  # uneven cards
    out = tp.distributed_sort([[w[:32], w[32:]]], mesh=mesh)
    np.testing.assert_array_equal(tp.gather_valid(out[0], out[2])[0], np.arange(64))
