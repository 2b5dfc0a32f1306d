"""The port's distributed shuffle (rdst_tpu_torch.parallel) against the JAX
package's (rdst_tpu.parallel).

The JAX side runs on the virtual 8-device CPU mesh of ``conftest.py``,
exactly as ``tests/test_parallel.py`` runs it; the port runs
``make_mesh(8, device="cpu")``, whose exchange is kernel B6's plain version.
Both get the same numpy inputs.  Per-shard counts are equal; stable runs
give bit-equal device-major valid slices; unstable runs give bit-equal keys
and the same (key, payload) multiset on every shard; partitions are equal.
Inputs are the ones the JAX package's own tests use (test_parallel.py,
test_overflow.py, test_exchange_parity.py, test_mesh2d.py).
"""
import jax
import numpy as np
import pytest
import torch
from test_exchange_parity import _emulated_ragged_all_to_all

import rdst_tpu.config as jconfig
from rdst_tpu import parallel as jp
from rdst_tpu_torch import config
from rdst_tpu_torch import parallel as tp
from rdst_tpu_torch.ops import fused_merge as fm
from rdst_tpu_torch.parallel import remote_dma as rd

torch.set_num_threads(1)

N = 1 << 12  # 2^9 rows per shard


@pytest.fixture(scope="module")
def meshes():
    return jp.make_mesh(8), tp.make_mesh(8, device="cpu")


def _u64_planes(x):
    return [(x >> np.uint64(32)).astype(np.uint32),
            (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)]


def _hot_bucket_input(rng, n):
    """test_overflow.py: ~88% of rows in one multi-key bucket (refines)."""
    x = rng.integers(0, 1 << 8, size=n, dtype=np.uint64)
    x[: n // 8] = rng.integers(0, 2**64, size=n // 8, dtype=np.uint64)
    return x


def _deep_hot_input(rng, n):
    """test_overflow.py: concentration four 16-bit fields deep, beyond what
    two refinement levels balance."""
    def field():
        v = rng.integers(0, 1 << 16, size=n).astype(np.uint64)
        v[rng.random(n) < 0.9] = 0
        return v

    lo = rng.integers(0, 1 << 16, size=n).astype(np.uint64)
    return ((field() << np.uint64(48)) | (field() << np.uint64(32))
            | (field() << np.uint64(16)) | lo)


def _hidden_word_input(rng, n):
    """test_overflow.py::test_refinement_hidden_word (the 37a2195 fix)."""
    w0 = np.zeros(n, np.uint32)
    w1 = np.zeros(n, np.uint32)
    w2 = rng.integers(0, 2**32, n).astype(np.uint32)
    hot = np.ones(n, bool)
    hot[: n // 8] = False
    w0[~hot] = (rng.integers(0, 2**32, (~hot).sum()).astype(np.uint32)
                | np.uint32(1 << 31))
    w0[hot] = rng.integers(0, 2, hot.sum()).astype(np.uint32)
    a, b = hot & (w0 == 0), hot & (w0 == 1)
    w1[a] = np.where(rng.random(a.sum()) < 0.5, 77, 200).astype(np.uint32)
    w1[b] = np.where(rng.random(b.sum()) < 0.5, 3, 77).astype(np.uint32)
    return [w0, w1, w2]


def _input(name, rng, n=N):
    """(key words, capacity_factor) of one named distribution."""
    if name == "u32":
        return [rng.integers(0, 2**32, size=n, dtype=np.uint32)], 1.5
    if name == "u64":
        return _u64_planes(rng.integers(0, 2**64, size=n, dtype=np.uint64)), 1.5
    if name == "skewed":  # test_parallel.py:50-64
        hot = np.full(n // 2, 0xAB000000, dtype=np.uint32) + rng.integers(
            0, 1000, n // 2).astype(np.uint32)
        x = np.concatenate([hot, rng.integers(0, 2**32, size=n // 2,
                                              dtype=np.uint32)])
        rng.shuffle(x)
        return [x], 5.0
    if name == "all_equal":
        return [np.full(n, 7, dtype=np.uint32)], 1.05
    if name == "hot_key":  # one key on 75% of the rows
        x = np.concatenate([np.full(3 * n // 4, 0xDEADBEEF, dtype=np.uint32),
                            rng.integers(0, 2**32, size=n // 4, dtype=np.uint32)])
        rng.shuffle(x)
        return [x], 1.5
    if name == "hot_bucket":
        return _u64_planes(_hot_bucket_input(rng, n)), 8.0
    if name == "hidden_word":
        return _hidden_word_input(rng, n), 8.0
    if name == "low_entropy":
        return [rng.integers(0, 2**32, size=n, dtype=np.uint32) % np.uint32(13)
                for _ in range(2)], 3.0
    raise KeyError(name)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(jout, tout, n_words, stable):
    """Counts equal; stable: every valid slice bit-equal; unstable: keys
    bit-equal and each shard's (key, payload) rows equal as multisets."""
    jc, tc = _np(jout[2]), _np(tout[2])
    np.testing.assert_array_equal(tc, jc)
    jpl = [_np(p) for p in list(jout[0]) + list(jout[1])]
    tpl = [_np(p) for p in list(tout[0]) + list(tout[1])]
    D = jc.shape[0]
    for a, b in zip(jpl, tpl):
        assert a.shape == b.shape and a.dtype == b.dtype
    cap = jpl[0].shape[0] // D
    for d in range(D):
        sl = slice(d * cap, d * cap + min(int(jc[d]), cap))
        for i, (a, b) in enumerate(zip(jpl, tpl)):
            if stable or i < n_words:
                np.testing.assert_array_equal(b[sl], a[sl])
        if not stable:
            rows_j = sorted(zip(*[a[sl].tolist() for a in jpl]))
            rows_t = sorted(zip(*[b[sl].tolist() for b in tpl]))
            assert rows_t == rows_j


def _both(meshes, words, pays, **kw):
    jm, tm = meshes
    return (jp.distributed_sort(words, pays, mesh=jm, **kw),
            tp.distributed_sort(words, pays, mesh=tm, **kw))


@pytest.mark.parametrize("dist,stable", [
    ("u32", False), ("u64", True), ("skewed", False), ("all_equal", True),
    ("all_equal", False), ("hot_key", True), ("hot_key", False),
    ("hot_bucket", True), ("hidden_word", False), ("low_entropy", True),
    ("low_entropy", False),
])
def test_distributed_sort_matches_jax(meshes, dist, stable):
    rng = np.random.default_rng(sum(map(ord, dist)))
    words, cf = _input(dist, rng)
    pay = np.arange(N, dtype=np.uint32)
    jout, tout = _both(meshes, words, [pay], capacity_factor=cf, stable=stable)
    _assert_same(jout, tout, len(words), stable)
    dense = tp.gather_valid(tout[0] + tout[1], tout[2])
    order = np.lexsort(words[::-1])
    for got, src in zip(dense[:len(words)], words):
        np.testing.assert_array_equal(got, src[order])
    if stable:
        np.testing.assert_array_equal(dense[-1], pay[order])
    if dist == "all_equal":  # the single-key bucket splits by exact rank
        assert _np(tout[2]).max() == N // 8


@pytest.mark.parametrize("case", ["uniform", "small_right"])
def test_partition_and_copartition_match_jax(meshes, case):
    """``split_uniform=False, return_partition=True`` returns the same
    partition, and ``partition_exchange`` of a second dataset under it
    gives the same shards (``small_right``: a 64-row table against a skewed
    partition, on the replication floor)."""
    jm, tm = meshes
    rng = np.random.default_rng(7)
    if case == "uniform":
        fact = rng.integers(0, 2**32, size=N, dtype=np.uint32)
        other = np.concatenate([fact[: N // 2],
                                rng.integers(0, 2**32, N // 2, dtype=np.uint32)])
        cf = 3.0
    else:
        fact = np.full(N, 7, dtype=np.uint32)
        fact[: N // 4] = rng.integers(0, 32, size=N // 4).astype(np.uint32)
        other = np.arange(32, dtype=np.uint32).repeat(2)
        cf = 2.0
    pay = np.arange(N, dtype=np.uint32)
    kw = dict(capacity_factor=cf, stable=True, split_uniform=False,
              return_partition=True)
    jout = jp.distributed_sort([fact], [pay], mesh=jm, **kw)
    tout = tp.distributed_sort([fact], [pay], mesh=tm, **kw)
    _assert_same(jout[:3], tout[:3], 1, True)
    for a, b in zip(jout[3], tout[3]):
        np.testing.assert_array_equal(_np(b).astype(np.int64),
                                      _np(a).astype(np.int64))
    opay = np.arange(other.size, dtype=np.uint32) * 3
    kw = dict(capacity_factor=cf, stable=True)
    jx = jp.partition_exchange([other], [opay], jout[3], mesh=jm, **kw)
    tx = tp.partition_exchange([other], [opay], tout[3], mesh=tm, **kw)
    _assert_same(jx, tx, 1, True)
    # the port under the JAX package's partition lands rows identically
    _assert_same(jx, tp.partition_exchange([other], [opay], jout[3], mesh=tm,
                                           **kw), 1, True)
    if case == "small_right":
        assert int(_np(tx[2]).sum()) == other.size
        assert tx[0][0].shape[0] == 8 * other.size  # full-table capacity


@pytest.mark.parametrize("n_local,dist,stable", [
    (1 << 9, "hot_key", False), (1 << 15, "u64", True),
])
def test_overlapped_exchange_matches(meshes, n_local, dist, stable):
    """``overlap_exchange=True`` equals the sequential exchange and the JAX
    package's; at 2^15 rows per shard the phases merge through the fused
    merge (B4/B5 plain versions)."""
    rng = np.random.default_rng(n_local)
    words, cf = _input(dist, rng, 8 * n_local)
    pay = rng.integers(0, 2**32, size=8 * n_local, dtype=np.uint32)
    kw = dict(capacity_factor=1.25 if n_local > 512 else cf, stable=stable)
    before = fm.MERGE_STAGE.plain_calls, fm.MERGE_TAIL.plain_calls
    jout, tout = _both(meshes, words, [pay], overlap_exchange=True, **kw)
    if n_local > 512:
        assert fm.MERGE_STAGE.plain_calls > before[0]
        assert fm.MERGE_TAIL.plain_calls > before[1]
    _assert_same(jout, tout, len(words), stable)
    seq = tp.distributed_sort(words, [pay], mesh=meshes[1], **kw)
    _assert_same(seq, tout, len(words), stable)


@pytest.mark.parametrize("option,value", [
    ("shuffle_refine_levels", 0), ("shuffle_refine_levels", 1),
    ("replicate_capacity_max", 0),
])
def test_config_options_match_jax(meshes, monkeypatch, option, value):
    """The shuffle's options act as the JAX package's: without refinement
    the hot multi-key bucket stays on one shard (one level spreads it); with
    no replication floor a small table gets only the factor's capacity."""
    jm, tm = meshes
    rng = np.random.default_rng(16)
    if option == "shuffle_refine_levels":
        words, cf = _input("hot_bucket", rng)
        pay = np.arange(N, dtype=np.uint32)
        refined = tp.distributed_sort(words, [pay], mesh=tm, capacity_factor=cf,
                                      stable=True)
        monkeypatch.setattr(jconfig, option, value)
        monkeypatch.setattr(config, option, value)
        jout, tout = _both(meshes, words, [pay], capacity_factor=cf, stable=True)
        _assert_same(jout, tout, 2, True)
        worst, best = int(_np(tout[2]).max()), int(_np(refined[2]).max())
        assert worst > best if value == 0 else worst == best
        return
    fact = np.full(N, 7, dtype=np.uint32)
    fact[: N // 4] = rng.integers(0, 32, size=N // 4).astype(np.uint32)
    other = np.arange(32, dtype=np.uint32).repeat(2)
    kw = dict(capacity_factor=2.0, stable=True)
    part = jp.distributed_sort([fact], mesh=jm, split_uniform=False,
                               return_partition=True, **kw)[3]
    monkeypatch.setattr(jconfig, option, value)
    monkeypatch.setattr(config, option, value)
    jx = jp.partition_exchange([other], [other], part, mesh=jm, **kw)
    tx = tp.partition_exchange([other], [other], part, mesh=tm, **kw)
    assert tx[0][0].shape == jx[0][0].shape == (8 * 16,)  # ceil(2.0 * 8), floor 16
    _assert_same(jx, tx, 1, True)


@pytest.mark.parametrize("max_cf", [16.0, 1.5])
def test_auto_retry_matches_jax(meshes, max_cf):
    """``distributed_sort_auto`` on ``_deep_hot_input``: from factor 1.1 it
    reaches the same capacity as the JAX package, bit-equal; capped below
    what the input needs, both raise OverflowError."""
    jm, tm = meshes
    rng = np.random.default_rng(11)
    words = _u64_planes(_deep_hot_input(rng, N))
    pay = np.arange(N, dtype=np.uint32)
    kw = dict(capacity_factor=1.1, max_capacity_factor=max_cf, stable=True)
    if max_cf < 2:
        with pytest.raises(OverflowError):
            jp.distributed_sort_auto(words, [pay], mesh=jm, **kw)
        with pytest.raises(OverflowError):
            tp.distributed_sort_auto(words, [pay], mesh=tm, **kw)
        return
    jout = jp.distributed_sort_auto(words, [pay], mesh=jm, **kw)
    tout = tp.distributed_sort_auto(words, [pay], mesh=tm, **kw)
    assert tout[0][0].shape == jout[0][0].shape  # the same final capacity
    assert tout[0][0].shape[0] > 8 * int(np.ceil(1.1 * N / 8))
    _assert_same(jout, tout, 2, True)


def test_overflow_counts_match_jax(meshes):
    """A demand past the capacity is reported, not lost: the same counts as
    the JAX package's, and gather_valid raises on both."""
    rng = np.random.default_rng(12)
    words = _u64_planes(_deep_hot_input(rng, N))
    jout, tout = _both(meshes, words, [], capacity_factor=1.1)
    np.testing.assert_array_equal(_np(tout[2]), _np(jout[2]))
    assert _np(tout[2]).max() > tout[0][0].shape[0] // 8
    with pytest.raises(OverflowError):
        tp.gather_valid(tout[0], tout[2])
    with pytest.raises(OverflowError):
        jp.gather_valid(jout[0], jout[2])


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (8, 1)])
def test_hier_sort_matches_jax_and_flat(meshes, shape):
    """The 2-axis (host, chip) exchange: the JAX package's output on the
    same mesh shape, and the port's own flat mesh, bit for bit."""
    jm2 = jp.make_mesh_2d(*shape)
    tm2 = tp.make_mesh_2d(*shape, device="cpu")
    rng = np.random.default_rng(sum(shape) * shape[0])
    words = _u64_planes(rng.integers(0, 2**16, size=N, dtype=np.uint64))
    pay = np.arange(N, dtype=np.uint32)
    for overlap in (False, True):
        kw = dict(stable=True, overlap_exchange=overlap)
        jout = jp.distributed_sort(words, [pay], mesh=jm2, axis=jm2.axis_names, **kw)
        tout = tp.distributed_sort(words, [pay], mesh=tm2, axis=tm2.axis_names, **kw)
        _assert_same(jout, tout, 2, True)
    flat = tp.distributed_sort(words, [pay], mesh=meshes[1], stable=True)
    a = tp.gather_valid(flat[0] + flat[1], flat[2])
    b = tp.gather_valid(tout[0] + tout[1], tout[2])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _column_funnel_input(rng, H, C, n_local):
    """test_overflow.py: chip column 0 holds every row bound for the top
    hosts, so stage 1 funnels ~C x its final load through it."""
    n = H * C * n_local
    lo = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    hi = rng.integers(1 << 31, 1 << 32, size=n, dtype=np.uint32).astype(np.uint32)
    x = np.empty(n, dtype=np.uint32)
    for h in range(H):
        for c in range(C):
            s = (h * C + c) * n_local
            x[s:s + n_local] = (hi if c == 0 else lo)[s:s + n_local]
    return x


@pytest.mark.parametrize("headroom", [1.0, 5.0])
def test_hier_stage1_poisoning_matches_jax(monkeypatch, headroom):
    """A stage-1 overflow poisons the reported count past the capacity (so
    gather_valid raises) though the final distribution fits; enough
    ``hier_stage1_headroom`` absorbs it.  Same counts as the JAX package's
    ragged exchange (emulated as in test_exchange_parity.py: the dense
    emulation keeps rows that a ragged stage-1 buffer drops)."""
    monkeypatch.setattr(jax.lax, "ragged_all_to_all", _emulated_ragged_all_to_all)
    H, C = 2, 4
    jm2, tm2 = jp.make_mesh_2d(H, C), tp.make_mesh_2d(H, C, device="cpu")
    x = _column_funnel_input(np.random.default_rng(13), H, C, 1 << 9)
    monkeypatch.setattr(jconfig, "hier_stage1_headroom", headroom)
    monkeypatch.setattr(config, "hier_stage1_headroom", headroom)
    jout = jp.distributed_sort([x], mesh=jm2, axis=jm2.axis_names,
                               capacity_factor=1.3, use_ragged=True)
    tout = tp.distributed_sort([x], mesh=tm2, axis=tm2.axis_names, capacity_factor=1.3)
    np.testing.assert_array_equal(_np(tout[2]), _np(jout[2]))
    if headroom < 2:
        with pytest.raises(OverflowError):
            tp.gather_valid(tout[0], tout[2])
    else:
        np.testing.assert_array_equal(tp.gather_valid(tout[0], tout[2])[0], np.sort(x))
        _assert_same(jout, tout, 1, False)


def test_hier_overflow_and_auto_retry(meshes):
    """Deep skew overflows the 2-axis mesh as the JAX package's does, and
    ``distributed_sort_auto`` converges there to a bit-exact sort."""
    jm2, tm2 = jp.make_mesh_2d(2, 4), tp.make_mesh_2d(2, 4, device="cpu")
    words = _u64_planes(_deep_hot_input(np.random.default_rng(14), N))
    kw = dict(axis=("host", "chip"), capacity_factor=1.1)
    jout = jp.distributed_sort(words, mesh=jm2, **kw)
    tout = tp.distributed_sort(words, mesh=tm2, **kw)
    np.testing.assert_array_equal(_np(tout[2]), _np(jout[2]))
    with pytest.raises(OverflowError):
        tp.gather_valid(tout[0], tout[2])
    tout = tp.distributed_sort_auto(words, mesh=tm2, **kw)
    x = (words[0].astype(np.uint64) << np.uint64(32)) | words[1]
    dense = tp.gather_valid(tout[0], tout[2])
    got = (dense[0].astype(np.uint64) << np.uint64(32)) | dense[1]
    np.testing.assert_array_equal(got, np.sort(x))


def test_exchange_runs_b6_and_payload_dtypes(meshes):
    """Every exchange of the 1-axis shuffle goes through B6 (here its plain
    version, once per sender and plane); 4-byte payloads of other dtypes
    come back in their own dtype; a narrow payload or a wide key raises."""
    tm = meshes[1]
    rng = np.random.default_rng(15)
    k = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    f = rng.standard_normal(N).astype(np.float32)
    i = rng.integers(-2**31, 2**31, size=N).astype(np.int32)
    before = rd.EXCHANGE.plain_calls
    w, (pf, pi), c = tp.distributed_sort([k], [f, i], mesh=tm, stable=True)
    assert rd.EXCHANGE.plain_calls - before == 8 * 3
    assert pf.dtype == torch.float32 and pi.dtype == torch.int32
    order = np.argsort(k, kind="stable")
    got = tp.gather_valid([w[0], pf, pi], c)
    np.testing.assert_array_equal(got[1].view(np.uint32), f[order].view(np.uint32))
    np.testing.assert_array_equal(got[2], i[order])
    with pytest.raises(TypeError):
        tp.distributed_sort([k], [k.astype(np.uint16)], mesh=tm)
    with pytest.raises(TypeError):
        tp.distributed_sort([k.astype(np.uint64)], mesh=tm)
    with pytest.raises(ValueError):
        tp.distributed_sort([k], mesh=tm, axis="other")
    with pytest.raises(ValueError):
        tp.distributed_sort([k[:-1]], mesh=tm)


def test_mesh_groups_and_collectives():
    m = tp.make_mesh_2d(2, 4, device="cpu")
    assert m.size == 8 and m.shape == (2, 4)
    assert m.groups("host") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.groups("chip") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    xs = [torch.tensor([s, -s]) for s in m.shards]
    assert m.psum(xs).tolist() == [28, -28]
    assert m.pmin(xs).tolist() == [0, -7]
    assert m.pmax(xs).tolist() == [7, 0]
    assert m.all_gather(xs).shape == (8, 2)
    assert tp.make_mesh(1, device="cpu").groups("shard") == [[0]]
    with pytest.raises(ValueError):
        m.psum(xs[:7])  # one value per shard
