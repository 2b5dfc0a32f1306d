"""The port's fused bitonic merge (ops/fused_merge.py, kernels B4/B5) and
``ops/merge.py`` against the JAX package's.

The plain versions of B4 and B5 run against the Pallas ``_pallas_stage`` and
``_pallas_tail`` in interpret mode on identical inputs, and the port's
``bitonic_merge_fused``, ``merge_level``, ``merge_sorted`` and
``merge_many`` against the JAX ones.  ``pallas_merge.pick_block`` and
``CHUNK`` are patched small so that the Pallas phase-A stage kernel really
runs (its legacy ``BLOCK`` constant is not what ``bitonic_merge_fused``
reads), and ``config.bitonic_smem_bytes`` so that the port's merges take B4
as well as B5.  Every comparison is bit for bit, riders included: both
sides run the same ascending stages with strict compares.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdst_tpu.ops.merge as jmerge
import rdst_tpu.ops.pallas_merge as pm
from rdst_tpu_torch import config
from rdst_tpu_torch.ops import fused_merge as fm
from rdst_tpu_torch.ops import merge as tmerge

torch.set_num_threads(1)

U8, U16, U32, F32 = np.uint8, np.uint16, np.uint32, np.float32


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setenv("RDST_TPU_FORCE_INTERPRET", "1")
    monkeypatch.setattr(pm, "pick_block", lambda n_planes: 1024)
    monkeypatch.setattr(pm, "CHUNK", 512)
    # port blocks: 2048 elements at 1 plane, 1024 at 2, 512 at 3-4
    monkeypatch.setattr(config, "bitonic_smem_bytes", 18432)


@pytest.fixture
def pallas_stages(monkeypatch):
    """Counts the Pallas phase-A launches of the JAX side."""
    calls = []
    real = pm._pallas_stage

    def spy(planes, n, s, n_keys, interpret):
        calls.append(s)
        return real(planes, n, s, n_keys, interpret)

    monkeypatch.setattr(pm, "_pallas_stage", spy)
    return calls


def _planes(rng, n, dtypes, lo=None):
    out = []
    for dt in dtypes:
        if np.dtype(dt).kind == "f":
            out.append(rng.standard_normal(n).astype(dt))
            continue
        top = np.iinfo(dt).max if lo is None else lo
        out.append(rng.integers(0, int(top) + 1, size=n, dtype=np.int64).astype(dt))
    return out


def _sorted_run(rng, n, dtypes, n_keys, lo=None):
    planes = _planes(rng, n, dtypes, lo)
    order = np.lexsort(planes[:n_keys][::-1])
    return [p[order] for p in planes]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize(
    "n,s,dtypes,n_keys",
    [
        (4096, 2048, [U32], 1),
        (4096, 512, [U32, U32, U32], 2),
        (8192, 1024, [U16, U32, U8], 2),
        (2048, 128, [U32] * 8, 3),
    ],
)
def test_stage_plain_matches_pallas(n, s, dtypes, n_keys):
    rng = np.random.default_rng(n + s)
    planes = _planes(rng, n, dtypes, lo=5)  # low entropy: many ties
    before = fm.MERGE_STAGE.plain_calls
    got = fm.merge_stage_call(_t(planes), n, s, n_keys)
    assert fm.MERGE_STAGE.plain_calls == before + 1
    _same(got, pm._pallas_stage(_j(planes), n, s, n_keys, True))


@pytest.mark.parametrize(
    "n,block,dtypes,n_keys",
    [
        (4096, 1024, [U32], 1),
        (4096, 2048, [U32, U32, U32], 2),
        (2048, 256, [U16, U32, U8], 1),
        (1024, 512, [U32] * 8, 3),
    ],
)
def test_tail_plain_matches_pallas(n, block, dtypes, n_keys):
    rng = np.random.default_rng(n + block)
    planes = _planes(rng, n, dtypes, lo=5)
    before = fm.MERGE_TAIL.plain_calls
    got = fm.merge_tail_call(_t(planes), n, block, n_keys)
    assert fm.MERGE_TAIL.plain_calls == before + 1
    _same(got, pm._pallas_tail(_j(planes), n, block, n_keys, True))


@pytest.mark.parametrize(
    "m,dtypes,n_keys,lo",
    [
        (2048, [U32], 1, None),
        (4096, [U32, U32], 1, 53),
        (2048, [U32, U32, U32], 2, 53),
        (1024, [U16, U32, U32, U8], 2, 7),
        (2048, [U32, F32], 1, 53),
        (128, [U32, U32], 2, 3),
    ],
)
def test_bitonic_merge_fused_matches_pallas(m, dtypes, n_keys, lo, pallas_stages):
    rng = np.random.default_rng(m + len(dtypes))
    a = _sorted_run(rng, m, dtypes, n_keys, lo)
    b = _sorted_run(rng, m, dtypes, n_keys, lo)
    z = [np.concatenate([pa, pb[::-1]]) for pa, pb in zip(a, b)]
    before = fm.MERGE_STAGE.plain_calls, fm.MERGE_TAIL.plain_calls
    got = fm.bitonic_merge_fused(_t(z), n_keys)
    want = pm.bitonic_merge_fused(_j(z), n_keys)
    _same(got, want)
    order = np.lexsort([np.concatenate([pa, pb]) for pa, pb in
                        zip(a[:n_keys], b[:n_keys])][::-1])
    for i in range(n_keys):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.concatenate([a[i], b[i]])[order])
    assert fm.MERGE_TAIL.plain_calls == before[1] + 1
    big = 2 * m > fm.pick_block(len(dtypes))
    assert (fm.MERGE_STAGE.plain_calls > before[0]) == big
    assert bool(pallas_stages) == (2 * m > 1024)


@pytest.mark.parametrize("m,n_runs,dtypes,n_keys", [
    (2048, 4, [U32, U32], 1),
    (256, 8, [U32, U16, F32], 2),
])
def test_merge_level_matches_pallas(m, n_runs, dtypes, n_keys):
    rng = np.random.default_rng(m * n_runs)
    runs = [_sorted_run(rng, m, dtypes, n_keys, lo=29) for _ in range(n_runs)]
    planes = [np.concatenate([r[i] for r in runs]) for i in range(len(dtypes))]
    before = fm.MERGE_TAIL.plain_calls
    got = fm.merge_level(_t(planes), m, n_keys)
    assert fm.MERGE_TAIL.plain_calls == before + 1
    _same(got, pm.merge_level(_j(planes), m, n_keys))


def _merge_inputs(rng, la, lb, all_ones):
    a = _sorted_run(rng, la, [U32, U32], 1, lo=40)
    b = _sorted_run(rng, lb, [U32, U32], 1, lo=40)
    if all_ones:  # real all-ones keys at both tails
        a[0][-50:] = b[0][-70:] = 0xFFFFFFFF
    return a, b


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("la,lb,all_ones", [(2048, 2048, False),
                                             (3000, 1096, True)])
def test_merge_sorted_matches_jax(monkeypatch, stable, la, lb, all_ones):
    monkeypatch.setattr(tmerge, "_FUSED_MIN", 256)
    monkeypatch.setattr(jmerge, "_FUSED_MIN", 256)
    rng = np.random.default_rng(la)
    a, b = _merge_inputs(rng, la, lb, all_ones)
    before = fm.MERGE_STAGE.plain_calls, fm.MERGE_TAIL.plain_calls
    got = tmerge.merge_sorted(_t(a), _t(b), 1, stable=stable)
    assert fm.MERGE_STAGE.plain_calls > before[0]
    assert fm.MERGE_TAIL.plain_calls > before[1]
    _same(got, jmerge.merge_sorted(_j(a), _j(b), 1, stable=stable))
    keys = np.concatenate([a[0], b[0]])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got[0].numpy(), keys[order])
    if stable:
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.concatenate([a[1], b[1]])[order])


def test_merge_sorted_below_fused_min_is_the_stage_loop(monkeypatch):
    """Below _FUSED_MIN both packages take their stage loops; the port's
    gives what its fused merge gives."""
    monkeypatch.setattr(jmerge, "_FUSED_MIN", 1 << 30)
    rng = np.random.default_rng(5)
    a, b = _merge_inputs(rng, 700, 324, True)
    before = fm.MERGE_TAIL.plain_calls
    loop = tmerge.merge_sorted(_t(a), _t(b), 1, stable=True)
    assert fm.MERGE_TAIL.plain_calls == before
    _same(loop, jmerge.merge_sorted(_j(a), _j(b), 1, stable=True))
    monkeypatch.setattr(tmerge, "_FUSED_MIN", 256)
    _same(tmerge.merge_sorted(_t(a), _t(b), 1, stable=True), loop)
    assert fm.MERGE_TAIL.plain_calls == before + 1


@pytest.mark.parametrize("n_runs,stable", [(3, True), (5, False)])
def test_merge_many_odd_runs_matches_jax(monkeypatch, n_runs, stable):
    monkeypatch.setattr(tmerge, "_FUSED_MIN", 256)
    monkeypatch.setattr(jmerge, "_FUSED_MIN", 256)
    rng = np.random.default_rng(n_runs)
    m = 512
    runs = [_sorted_run(rng, m, [U32, U32], 1, lo=30) for _ in range(n_runs)]
    runs[-1][0][-20:] = 0xFFFFFFFF  # real all-ones keys tie with the pads
    before = fm.MERGE_TAIL.plain_calls
    got = tmerge.merge_many([_t(r) for r in runs], 1, stable=stable)
    assert fm.MERGE_TAIL.plain_calls > before
    _same(got, jmerge.merge_many([_j(r) for r in runs], 1, stable=stable))
    total = m * n_runs
    keys = np.concatenate([r[0] for r in runs])
    np.testing.assert_array_equal(got[0].numpy()[:total], np.sort(keys))
    if stable:  # pads only at the tail, behind the real all-ones keys
        assert (got[1].numpy()[total:] == 0).all()
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(got[1].numpy()[:total],
                                      np.concatenate([r[1] for r in runs])[order])


def test_fused_merge_available_rules():
    ok = [torch.zeros(1024, dtype=torch.uint32)]
    assert fm.fused_merge_available(ok)
    assert not fm.fused_merge_available([torch.zeros(1000, dtype=torch.uint32)])
    assert not fm.fused_merge_available([torch.zeros(128, dtype=torch.uint32)])
    assert not fm.fused_merge_available(ok * 9)
    assert not fm.fused_merge_available([torch.zeros(1024, dtype=torch.int64)])
    assert not fm.fused_merge_available([torch.zeros(1024, dtype=torch.int32)])
    rider = torch.zeros(1024, dtype=torch.float32)
    assert fm.fused_merge_available(ok + [rider], n_keys=1)
    assert not fm.fused_merge_available(ok + [rider])  # a float key
    assert not fm.fused_merge_available(ok + [torch.zeros(1024, dtype=torch.bool)],
                                        n_keys=1)
