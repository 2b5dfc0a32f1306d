"""The port's sort path end to end, against the same calls on ``rdst_tpu``.

Both packages get the same numpy input (made from a seed) on the CPU; the
port runs with ``device="cpu"``, so its kernel wrappers take their plain
versions, and with ``fused_min_elems`` lowered so the fused executor runs at
these sizes.  Every comparison is exact: sorted keys and stable payloads are
bit-equal, unstable payloads are compared as (key, payload) multisets, and
the ``(level) PLAN:`` traces are identical strings.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import rdst_tpu
import rdst_tpu.engine
import rdst_tpu_torch as rt
from rdst_tpu_torch import config, engine
from rdst_tpu_torch.ops import fused_sort as fs
from rdst_tpu_torch.ops import histogram as th
from rdst_tpu_torch.tuner import Algorithm

torch.set_num_threads(1)

N = 5000  # above the JAX package's host-path cutoff in tests (2048)


@pytest.fixture(autouse=True)
def _fused_at_small_n(monkeypatch):
    monkeypatch.setattr(config, "fused_min_elems", 2048)
    monkeypatch.setattr(config, "fused_min_piece", 1024)
    # blocks of 512-2048 elements, so span trips run at these sizes too
    monkeypatch.setattr(config, "bitonic_smem_bytes", 18432)


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _keys(dt, rng, n=N):
    dt = np.dtype(dt)
    if dt.kind == "f":
        x = rng.standard_normal(n).astype(dt)
        x[:6] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf]
        return x
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, size=n, dtype=dt)


@pytest.mark.parametrize(
    "dt", ["uint8", "int16", "float16", "uint32", "int32", "float32",
           "uint64", "int64", "float64"])
def test_radix_sort_unstable_matches_jax(dt):
    rng = np.random.default_rng(len(dt))
    x = _keys(dt, rng)
    counts = (th.HISTOGRAM.plain_calls, fs.TAIL.plain_calls)
    got = rt.radix_sort_unstable(x, device="cpu")
    assert th.HISTOGRAM.plain_calls > counts[0]
    assert fs.TAIL.plain_calls > counts[1]
    want = rdst_tpu.radix_sort_unstable(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [N, 1 << 13, 9000])
def test_sort_key_value_stable_matches_jax(n):
    rng = np.random.default_rng(n)
    k = rng.integers(0, 300, size=n).astype(np.uint32)  # heavy ties
    v = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    before = fs.SPAN.plain_calls
    gk, gv = rt.sort_key_value(k, v, stable=True, device="cpu")
    assert fs.SPAN.plain_calls > before
    wk, wv = rdst_tpu.sort_key_value(k, v, stable=True)
    np.testing.assert_array_equal(gk, np.asarray(wk))
    np.testing.assert_array_equal(gv, np.asarray(wv))


@pytest.mark.parametrize("vdt", ["uint16", "float32", "int64", "bool"])
def test_sort_key_value_unstable_matches_jax(vdt):
    rng = np.random.default_rng(3)
    k = rng.integers(0, 50, size=N).astype(np.int64)
    v = {
        "uint16": lambda: _keys("uint16", rng),
        "float32": lambda: _keys("float32", rng),
        "int64": lambda: _keys("int64", rng),
        "bool": lambda: rng.integers(0, 2, size=N).astype(bool),
    }[vdt]()
    gk, gv = rt.sort_key_value(k, v, stable=False, device="cpu")
    wk, wv = rdst_tpu.sort_key_value(k, v, stable=False)
    assert gv.dtype == np.asarray(wv).dtype
    np.testing.assert_array_equal(gk, np.asarray(wk))
    got = sorted(zip(gk.tolist(), _bits(gv).tolist()))
    want = sorted(zip(np.asarray(wk).tolist(), _bits(wv).tolist()))
    assert got == want


@pytest.mark.parametrize("stable", [True, False])
def test_argsort_matches_jax(stable):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 100, size=N).astype(np.int32)
    got = rt.argsort(x, device="cpu", stable=stable)
    want = np.asarray(rdst_tpu.argsort(x, stable=stable))
    assert got.dtype == np.uint32
    if stable:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(x[got], x[want])
        assert sorted(got.tolist()) == list(range(N))


def _both(fn_t, fn_j, capsys):
    with config.work_profiles(True):
        got = fn_t()
    trace_t = capsys.readouterr().out
    with rdst_tpu.config.work_profiles(True):
        want = fn_j()
    trace_j = capsys.readouterr().out
    return got, want, trace_t, trace_j


@pytest.mark.parametrize(
    "setup",
    ["standard", "low_mem", "single_threaded", "no_parallel", "LSB", "SKA",
     "REGIONS", "SCANNING", "COMPARATIVE"])
def test_builder_tuners_and_traces_match_jax(setup, capsys):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**40, size=N, dtype=np.uint64)  # 3 constant bytes
    x[: N // 3] = 12345  # skew the top level

    def configure(b, pkg):
        if setup == "low_mem":
            return b.with_low_mem_tuner()
        if setup == "single_threaded":
            return b.with_single_threaded_tuner()
        if setup == "no_parallel":
            return b.with_parallel(False)
        if setup != "standard":
            return b.with_algorithm(pkg.Algorithm[setup])
        return b

    got, want, trace_t, trace_j = _both(
        lambda: configure(rt.radix_sort_builder(x, device="cpu"), rt).sort(),
        lambda: configure(rdst_tpu.radix_sort_builder(x), rdst_tpu).sort(),
        capsys,
    )
    np.testing.assert_array_equal(got, np.asarray(want))
    assert trace_t == trace_j
    assert "PLAN:" in trace_t


def test_presorted_merge_and_short_circuit_traces(monkeypatch, capsys):
    monkeypatch.setattr(config, "presorted_merge_min", 1024)
    monkeypatch.setattr(rdst_tpu.config, "presorted_merge_min", 1024)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    x[: 3 * N // 4] = np.sort(x[: 3 * N // 4])
    v = np.arange(N, dtype=np.uint32)
    (gk, gv), (wk, wv), trace_t, trace_j = _both(
        lambda: rt.sort_key_value(x, v, stable=True, device="cpu"),
        lambda: rdst_tpu.sort_key_value(x, v, stable=True),
        capsys,
    )
    assert "PresortedMerge" in trace_t and trace_t == trace_j
    np.testing.assert_array_equal(gk, np.asarray(wk))
    np.testing.assert_array_equal(gv, np.asarray(wv))
    y = (np.arange(N, dtype=np.uint32) // 300).astype(np.uint32)
    got, want, trace_t, trace_j = _both(
        lambda: rt.radix_sort_unstable(y, device="cpu"),
        lambda: rdst_tpu.radix_sort_unstable(y),
        capsys,
    )
    assert "AlreadySorted" in trace_t and trace_t == trace_j
    np.testing.assert_array_equal(got, np.asarray(want))


def test_composite_and_byte_array_keys_match_jax():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, size=N).astype(np.uint16)
    b = rng.standard_normal(N).astype(np.float32)
    ga, gb = rt.radix_sort_unstable((a, b), device="cpu")
    wa, wb = rdst_tpu.radix_sort_unstable((a, b))
    np.testing.assert_array_equal(ga, np.asarray(wa))
    np.testing.assert_array_equal(_bits(gb), _bits(wb))
    s = rng.integers(0, 256, size=(N, 5), dtype=np.uint8)
    np.testing.assert_array_equal(
        rt.radix_sort_unstable(s, device="cpu"),
        np.asarray(rdst_tpu.radix_sort_unstable(s)))


@pytest.mark.parametrize("plan", ["auto", "comparative", "packed"])
def test_engine_sort_words_matches_jax(plan):
    rng = np.random.default_rng(13)
    w = rng.integers(0, 2**32, size=(2, N), dtype=np.uint32)
    w[0] &= 0xFF
    p = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    counts = th.multi_level_histogram([torch.from_numpy(x) for x in w], 8).counts
    gw, gp = engine.sort_words([torch.from_numpy(x) for x in w],
                               [torch.from_numpy(p)], stable=True, plan=plan,
                               counts=counts)
    import jax.numpy as jnp

    ww, wp = rdst_tpu.engine.sort_words([jnp.asarray(x) for x in w],
                                        [jnp.asarray(p)], stable=True,
                                        plan=plan, counts=counts)
    for a, b in zip(gw + gp, list(ww) + list(wp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("algo", list(Algorithm), ids=lambda a: a.value)
def test_every_algorithm_plan_runs_and_matches_jax(algo, monkeypatch, capsys):
    """Every plan of the registry runs on CPU tensors; Regions with the
    memory gate forced open, so it takes the chunked path."""
    monkeypatch.setattr(config, "low_mem_threshold_bytes", 1)
    monkeypatch.setattr(rdst_tpu.config, "low_mem_threshold_bytes", 1)
    rng = np.random.default_rng(19)
    k = rng.integers(0, 2**32, size=N, dtype=np.uint32)
    k[::5] = 77  # ties
    v = np.arange(N, dtype=np.uint32)
    (gk, (gv,)), (wk, (wv,)), trace_t, trace_j = _both(
        lambda: rt.radix_sort_builder(k, [v], device="cpu")
        .with_algorithm(algo).with_stable().sort(),
        lambda: rdst_tpu.radix_sort_builder(k, [v])
        .with_algorithm(rdst_tpu.Algorithm[algo.name]).with_stable().sort(),
        capsys,
    )
    assert trace_t == trace_j and f"PLAN: {algo.value}" in trace_t
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(gk, k[order])
    np.testing.assert_array_equal(gv, v[order])
    np.testing.assert_array_equal(gk, np.asarray(wk))
    np.testing.assert_array_equal(gv, np.asarray(wv))


def test_tensor_input_sorts_on_its_device_and_returns_tensors():
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.integers(-(2**31), 2**31, size=N).astype(np.int32))
    v = torch.arange(N, dtype=torch.float32)
    k, (p,) = rt.radix_sort_builder(x, [v]).with_stable().sort()
    assert isinstance(k, torch.Tensor) and k.device.type == "cpu"
    order = np.argsort(x.numpy(), kind="stable")
    np.testing.assert_array_equal(k.numpy(), x.numpy()[order])
    np.testing.assert_array_equal(p.numpy(), v.numpy()[order])


def test_numpy_input_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the no-CUDA rule is not reachable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.radix_sort_unstable(np.arange(10, dtype=np.uint32))


def test_import_does_not_pull_in_jax():
    code = ("import sys, rdst_tpu_torch, rdst_tpu_torch.engine; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=root)


@pytest.mark.parametrize("tuner", ["StandardTuner", "LowMemoryTuner",
                                   "SingleThreadedTuner"])
def test_tuner_picks_match_jax(tuner):
    """The copied tuners pick the same Algorithm names over a sweep of
    sizes, depths and uniform / skewed counts."""
    import rdst_tpu.tuner as jt
    import rdst_tpu_torch.tuner as tt

    mine, ref = getattr(tt, tuner)(), getattr(jt, tuner)()
    for n in [100, 128, 129, 4_999, 5_000, 60_000, 150_001, 260_001, 350_001,
              900_000, 4_000_001, 5_000_001, 50_000_001]:
        for level, total in [(7, 8), (6, 8), (5, 8), (0, 1)]:
            for skew in (False, True):
                counts = [n // 256] * 256
                if skew:
                    counts[3] = n // 2
                a = mine.pick_algorithm(tt.TuningParams(8, level, total, n), counts)
                b = ref.pick_algorithm(jt.TuningParams(8, level, total, n), counts)
                assert a.value == b.value, (n, level, skew)
