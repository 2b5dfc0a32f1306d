"""The port's low-memory Regions path (sorts/regions.py ``chunked_sort``)
against the JAX package's.

The port runs with ``fused_min_elems`` lowered, so each chunk goes through
the fused executor (B2/B3), and with ``_FUSED_MIN`` lowered, so the merge
tree goes through the fused merge (B4/B5); all of them as plain versions,
since the tensors lie on the CPU.  The JAX side merges with its stage loop,
which runs the same stages.  Sorted keys and stable payloads are bit-equal;
a keys-only unstable sort is compared by its keys (the multiset); plan
traces are equal strings.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdst_tpu
import rdst_tpu.engine
import rdst_tpu.sorts.regions as jregions
import rdst_tpu_torch as rt
from rdst_tpu_torch import config, engine
from rdst_tpu_torch.ops import fused_merge as fm
from rdst_tpu_torch.ops import fused_sort as fs
from rdst_tpu_torch.ops import merge as tmerge
from rdst_tpu_torch.sorts import regions

torch.set_num_threads(1)

N = 5000  # not a multiple of 4 powers of two: the last chunk is padded


@pytest.fixture(autouse=True)
def _kernels_at_small_n(monkeypatch):
    monkeypatch.setattr(config, "fused_min_elems", 1024)
    monkeypatch.setattr(config, "fused_min_piece", 512)
    monkeypatch.setattr(config, "bitonic_smem_bytes", 18432)
    monkeypatch.setattr(tmerge, "_FUSED_MIN", 1024)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _counts():
    return (fs.TAIL.plain_calls, fm.MERGE_STAGE.plain_calls,
            fm.MERGE_TAIL.plain_calls)


def _ran_kernels(before):
    """The chunks took B2 and the merge tree took B4 and B5."""
    return all(a > b for a, b in zip(_counts(), before))


@pytest.mark.parametrize("n_words,n_pay,stable", [(2, 1, True), (1, 2, False)])
def test_chunked_sort_key_value_matches_jax(n_words, n_pay, stable):
    rng = np.random.default_rng(n_words * 10 + n_pay)
    words = rng.integers(0, 2**32, size=(n_words, N), dtype=np.uint32)
    words[0] %= 97  # ties across chunks
    words[0][:40] = 0xFFFFFFFF
    if n_words == 1:
        words[0][40:80] = 0xFFFFFFFF  # real all-ones keys tie with the pads
    pays = rng.integers(0, 2**32, size=(n_pay, N), dtype=np.uint32)
    before = _counts()
    gw, gp = regions.chunked_sort(_t(words), _t(pays), stable=stable)
    assert _ran_kernels(before)
    ww, wp = jregions.chunked_sort(_j(words), _j(pays), stable=stable)
    _same(gw + gp, list(ww) + list(wp))
    order = np.lexsort(words[::-1])
    for i in range(n_words):
        np.testing.assert_array_equal(gw[i].numpy(), words[i][order])
    if stable:
        np.testing.assert_array_equal(gp[0].numpy(), pays[0][order])


def test_chunked_sort_keys_only_unstable_with_all_ones_keys():
    rng = np.random.default_rng(3)
    k = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    k[:64] = 0xFFFFFFFF  # ties with the pad sentinel
    before = _counts()
    (gw,), gp = regions.chunked_sort(_t([k]), [], stable=False)
    assert _ran_kernels(before) and gp == []
    (ww,), _ = jregions.chunked_sort(_j([k]), [], stable=False)
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    np.testing.assert_array_equal(gw.numpy(), np.sort(k))


def test_engine_lowmem_matches_jax():
    rng = np.random.default_rng(13)
    w = rng.integers(0, 2**32, size=(2, N), dtype=np.uint32)
    w[0] &= 0xFF
    p = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    before = _counts()
    gw, gp = engine.sort_words(_t(w), _t([p]), stable=True, plan="lowmem")
    assert _ran_kernels(before)
    ww, wp = rdst_tpu.engine.sort_words(_j(w), _j([p]), stable=True,
                                        plan="lowmem")
    _same(gw + gp, list(ww) + list(wp))


@pytest.mark.parametrize("setup", ["low_mem_tuner", "REGIONS"])
def test_builder_low_memory_gate_matches_jax(monkeypatch, capsys, setup):
    """The memory gate forced open in both packages (as
    tests/test_algorithms.py does): a Regions pick runs chunked_sort."""
    monkeypatch.setattr(config, "low_mem_threshold_bytes", 1)
    monkeypatch.setattr(rdst_tpu.config, "low_mem_threshold_bytes", 1)
    rng = np.random.default_rng(21)
    k = rng.integers(0, 2**40, size=N, dtype=np.uint64)
    k[: N // 3] = 12345  # a skewed top level
    v = np.arange(N, dtype=np.uint32)

    def build(pkg, **kw):
        b = pkg.radix_sort_builder(k, [v], **kw).with_stable(True)
        if setup == "low_mem_tuner":
            return b.with_low_mem_tuner()
        return b.with_algorithm(pkg.Algorithm.REGIONS)

    before = _counts()
    with config.work_profiles(True):
        gk, (gv,) = build(rt, device="cpu").sort()
    trace_t = capsys.readouterr().out
    with rdst_tpu.config.work_profiles(True):
        wk, (wv,) = build(rdst_tpu).sort()
    trace_j = capsys.readouterr().out
    assert trace_t == trace_j and "PLAN:" in trace_t
    if setup == "REGIONS":
        assert "Regions" in trace_t and _ran_kernels(before)
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(gk, k[order])
    np.testing.assert_array_equal(gv, v[order])
    np.testing.assert_array_equal(gk, np.asarray(wk))
    np.testing.assert_array_equal(gv, np.asarray(wv))
