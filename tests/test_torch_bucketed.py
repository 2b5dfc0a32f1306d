"""The port's bucketed MtOop plan (sorts/msb.py) and its writeback
(ops/ragged_concat.py) against the JAX package's.

The cases of tests/test_algorithms.py that drive MT_OOP, each run through
both packages on the same numpy input: sorted keys and stable payloads
bit-equal, to each other and to numpy's stable order, and the plan traces
(``(msb) FALLBACK``, ``BatchedRows[...]``, ``SingleKeySkip``,
``(carved)``) equal strings.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdst_tpu
import rdst_tpu.engine
import rdst_tpu.ops.ragged_concat as jragged
import rdst_tpu_torch as rt
from rdst_tpu_torch import config, engine
from rdst_tpu_torch.ops import histogram as th
from rdst_tpu_torch.ops import ragged_concat as tragged

torch.set_num_threads(1)


def _run(capsys, x, v=None, *, tuners=None, stable=True):
    """Sort ``x`` (and payload ``v``) through both packages with MT_OOP, or
    with ``tuners`` = (port tuner, JAX tuner); returns both results and
    both traces."""
    out = []
    for pkg, tuner, kw in [(rt, tuners and tuners[0], {"device": "cpu"}),
                           (rdst_tpu, tuners and tuners[1], {})]:
        b = pkg.radix_sort_builder(x, [] if v is None else [v], **kw)
        b = b.with_tuner(tuner) if tuner else b.with_algorithm(
            pkg.Algorithm.MT_OOP)
        with pkg.config.work_profiles(True):
            res = b.with_stable(stable).sort()
        out.append((res, capsys.readouterr().out))
    (got, trace_t), (want, trace_j) = out
    assert trace_t == trace_j and "MtOop" in trace_t
    return got, want, trace_t


def _check(x, v, got, want):
    order = np.argsort(x, kind="stable")
    if v is None:
        np.testing.assert_array_equal(got, x[order])
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    (gk, (gv,)), (wk, (wv,)) = got, want
    np.testing.assert_array_equal(gk, x[order])
    np.testing.assert_array_equal(gv, v[order])
    np.testing.assert_array_equal(gk, np.asarray(wk))
    np.testing.assert_array_equal(gv, np.asarray(wv))


def test_bucketed_extreme_skew(capsys):
    rng = np.random.default_rng(1)
    x = np.full(50_000, 0xDEADBEEF, dtype=np.uint32)
    x[:100] = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    got, want, _ = _run(capsys, x)
    _check(x, None, got, want)


def test_bucketed_payload_stable_with_all_ones_keys(capsys):
    rng = np.random.default_rng(2)
    k = rng.integers(0, 2**32, size=50_000, dtype=np.uint32)
    k[::7] = 0xFFFFFFFF  # real max keys must not mix with row pads
    v = np.arange(50_000, dtype=np.uint32)
    got, want, trace = _run(capsys, k, v)
    assert "BatchedRows" in trace
    _check(k, v, got, want)


def _depth1_tuner(pkg):
    """MT_OOP at the top level, StandardTuner below: exercises the
    per-bucket re-tuning."""

    class Depth1:
        def __init__(self):
            self._std = pkg.StandardTuner()
            self.picks = []

        def pick_algorithm(self, p, counts):
            if p.depth == 0:
                return pkg.Algorithm.MT_OOP
            algo = self._std.pick_algorithm(p, counts)
            self.picks.append((p.level, p.input_len, algo.value))
            return algo

    return Depth1()


def test_bucketed_per_bucket_retune(capsys):
    rng = np.random.default_rng(3)
    n = 200_000
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    x[: int(n * 0.35)] = np.uint32(0x37AB_12CD)  # one hot key
    rng.shuffle(x)
    tuners = (_depth1_tuner(rt), _depth1_tuner(rdst_tpu))
    got, want, trace = _run(capsys, x, tuners=tuners, stable=False)
    _check(x, None, got, want)
    assert tuners[0].picks == tuners[1].picks
    picked = {a for (_, _, a) in tuners[0].picks}
    assert "MtOop" not in picked and len(picked) >= 2, picked
    assert "BatchedRows[" in trace


def test_bucketed_dominant_bucket_single_key_skip(capsys):
    rng = np.random.default_rng(4)
    n = 120_000
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    x[(x >> 24) == 0x55] ^= np.uint32(1 << 24)  # keep top byte 0x55 pure
    x[: n // 2] = np.uint32(0x5555_AAAA)
    rng.shuffle(x)
    v = np.arange(n, dtype=np.uint32)
    got, want, trace = _run(capsys, x, v)
    assert "FALLBACK" not in trace and "SingleKeySkip" in trace, trace
    _check(x, v, got, want)


def test_bucketed_dominant_multikey_carve(capsys):
    rng = np.random.default_rng(5)
    n = 100_000
    x = rng.integers(0, 2**32, size=n, dtype=np.int64).astype(np.uint32)
    hot = (rng.integers(0, 2**24, size=int(n * 0.6), dtype=np.int64)
           .astype(np.uint32) | np.uint32(0x42000000))
    x[: hot.shape[0]] = hot
    rng.shuffle(x)
    v = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got, want, trace = _run(capsys, x, v)
    assert "(carved)" in trace, trace
    _check(x, v, got, want)


def test_bucketed_max_elements_fallback(monkeypatch, capsys):
    monkeypatch.setattr(config, "max_bucketed_elements", 1000)
    monkeypatch.setattr(rdst_tpu.config, "max_bucketed_elements", 1000)
    rng = np.random.default_rng(6)
    x = rng.integers(0, 2**64, size=5000, dtype=np.uint64)
    got, want, trace = _run(capsys, x)
    assert "(msb) FALLBACK: Comparative (n=5000 > max_bucketed_elements=1000)" \
        in trace
    _check(x, None, got, want)


@pytest.mark.parametrize("stable", [True, False])
def test_engine_bucketed_matches_jax(stable):
    rng = np.random.default_rng(7)
    w = rng.integers(0, 2**32, size=(2, 30_000), dtype=np.uint32)
    w[0] %= 1000
    p = rng.integers(0, 2**32, size=30_000, dtype=np.uint32)
    counts = th.multi_level_histogram([torch.from_numpy(x) for x in w], 8).counts
    gw, gp = engine.sort_words([torch.from_numpy(x) for x in w],
                               [torch.from_numpy(p)], stable=stable,
                               plan="bucketed", counts=counts)
    ww, wp = rdst_tpu.engine.sort_words([jnp.asarray(x) for x in w],
                                        [jnp.asarray(p)], stable=stable,
                                        plan="bucketed", counts=counts)
    order = np.lexsort(w[::-1])
    for i in range(2):
        np.testing.assert_array_equal(gw[i].numpy(), w[i][order])
        np.testing.assert_array_equal(gw[i].numpy(), np.asarray(ww[i]))
    if stable:
        np.testing.assert_array_equal(gp[0].numpy(), np.asarray(wp[0]))
    else:
        got = sorted(zip(*(t.numpy().tolist() for t in gw + gp)))
        want = sorted(zip(*(np.asarray(t).tolist() for t in list(ww) + list(wp))))
        assert got == want


@pytest.mark.parametrize("host", [True, False])
@pytest.mark.parametrize("total_extra", [0, 37])
def test_ragged_concat_multi_matches_jax(host, total_extra):
    rng = np.random.default_rng(8 + total_extra)
    B, cap = 16, 40
    lengths = rng.integers(0, cap + 1, size=B).astype(np.int32)
    lengths[3] = 0
    planes = [rng.integers(0, 2**32, size=(B, cap), dtype=np.uint32),
              rng.integers(0, 2**16, size=(B, cap), dtype=np.uint16)]
    total = int(lengths.sum()) + total_extra
    got = tragged.ragged_concat_multi(
        [torch.from_numpy(p) for p in planes],
        lengths if host else torch.from_numpy(lengths), total)
    want = jragged.ragged_concat_multi(
        [jnp.asarray(p) for p in planes],
        lengths if host else jnp.asarray(lengths), total)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
