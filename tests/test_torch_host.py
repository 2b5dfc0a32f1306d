"""The port's native host runtime and the builder's host path, against the
JAX package's (``rdst_tpu_torch.native.host`` and ``_try_host_sort`` vs
``rdst_tpu.native.host`` and ``rdst_tpu/builder.py``), on the same seeded
numpy inputs."""
import pathlib

import numpy as np
import pytest
import torch

import rdst_tpu as jrt
import rdst_tpu_torch as rt
from rdst_tpu import config as jconfig
from rdst_tpu.native import host as jhost
from rdst_tpu_torch import builder as tbuilder
from rdst_tpu_torch import config
from rdst_tpu_torch.native import host

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = [
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64",
    "float16", "float32", "float64",
]


@pytest.fixture
def host_max(monkeypatch):
    """Both packages' host paths open to 2^20 elements."""
    monkeypatch.setattr(config, "host_sort_max", 1 << 20)
    monkeypatch.setattr(jconfig, "host_sort_max", 1 << 20)


@pytest.fixture
def host_calls(monkeypatch):
    calls = []
    real = host.host_radix_sort

    def counted(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(host, "host_radix_sort", counted)
    return calls


def _keys(dtype, n, rng):
    dt = np.dtype(dtype)
    if dt.kind == "u":
        return rng.integers(0, np.iinfo(dt).max, n, endpoint=True,
                            dtype=np.uint64).astype(dt)
    if dt.kind == "i":
        return rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, n,
                            endpoint=True, dtype=np.int64).astype(dt)
    x = rng.standard_normal(n).astype(dt)
    x[::97] = np.nan
    x[1::97] = -np.float64(np.nan)
    x[2::97] = -0.0
    x[3::97] = np.inf
    x[4::97] = -np.inf
    x[5::97] = 0.0
    return x


def _bits(a):
    return a.view(f"u{a.dtype.itemsize}")


# -- the library ---------------------------------------------------------


def test_library_builds_into_build():
    assert host.available()
    lib = host._target(host._compiler())
    assert lib.is_file()
    assert lib.parent.parent == ROOT / "build" / "rdst_tpu_torch_host"


def test_source_is_the_reference_copy():
    """Only the header comment differs from the JAX package's source."""
    def body(path):
        lines = path.read_text().splitlines()
        while lines and lines[0].startswith("//"):
            lines.pop(0)
        return lines

    ours = ROOT / "rdst_tpu_torch" / "native" / "rdst_host.cpp"
    ref = ROOT / "rdst_tpu" / "native" / "rdst_host.cpp"
    assert body(ours) == body(ref)
    assert "63x" not in ours.read_text()


def test_hash_keys_on_cpu_and_flags(monkeypatch):
    cxx = host._compiler()
    base = host._target(cxx)
    monkeypatch.setattr(host, "_cpu_id", lambda: "another CPU")
    other_cpu = host._target(cxx)
    monkeypatch.undo()
    monkeypatch.setattr(host, "_FLAGS", host._FLAGS + ["-g"])
    other_flags = host._target(cxx)
    assert len({base.parent, other_cpu.parent, other_flags.parent}) == 3


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_host_radix_sort(dtype, rng):
    x = rng.integers(0, np.iinfo(dtype).max, size=300_000, endpoint=True,
                     dtype=dtype)
    got, none = host.host_radix_sort(x.copy())
    plain, _ = host.host_radix_sort_plain(x.copy())
    ref, _ = jhost.host_radix_sort(x.copy())
    assert none is None and got.dtype == dtype
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("distinct", [16, 1 << 20])
def test_host_radix_sort_pairs(dtype, distinct, rng):
    """Stable: equal keys keep their payloads' input order."""
    k = rng.integers(0, distinct, size=200_000).astype(dtype)
    v = rng.integers(0, 2**32, size=k.size, dtype=np.uint64).astype(np.uint32)
    gk, gv = host.host_radix_sort(k.copy(), v.copy())
    pk, pv = host.host_radix_sort_plain(k.copy(), v.copy())
    rk, rv = jhost.host_radix_sort(k.copy(), v.copy())
    for a, b in ((gk, pk), (gv, pv), (gk, rk), (gv, rv)):
        np.testing.assert_array_equal(a, b)


def test_host_radix_sort_presorted_and_edges(rng):
    x = np.sort(rng.integers(0, 2**64, size=100_000, dtype=np.uint64))
    np.testing.assert_array_equal(host.host_radix_sort(x.copy())[0], x)
    for n in (0, 1, 2):
        y = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        np.testing.assert_array_equal(host.host_radix_sort(y.copy())[0], np.sort(y))


def test_host_radix_sort_sorts_in_place(rng):
    x = rng.integers(0, 2**32, size=10_000, dtype=np.uint64).astype(np.uint32)
    v = np.arange(x.size, dtype=np.uint32)
    k, p = host.host_radix_sort(x, v)
    assert k is x and p is v
    np.testing.assert_array_equal(x, np.sort(k))


@pytest.mark.parametrize("bad", [np.int32, np.int64, np.float64, np.uint16])
def test_host_radix_sort_key_dtypes(bad):
    with pytest.raises(TypeError, match="unsupported key dtype"):
        host.host_radix_sort(np.arange(10).astype(bad))
    with pytest.raises(TypeError, match="unsupported key dtype"):
        host.host_radix_sort_plain(np.arange(10).astype(bad))


def test_host_histogram(rng):
    x = rng.integers(0, 2**32, size=100_000, dtype=np.uint64).astype(np.uint32)
    for lvl in range(4):
        got = host.host_histogram(x, lvl)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, host.host_histogram_plain(x, lvl))
        np.testing.assert_array_equal(got, jhost.host_histogram(x, lvl))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(host, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        host.available()
    x = np.arange(100, 0, -1, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="not found"):
        host.host_radix_sort(x)
    # the builder's host path does not fall back to numpy or the device
    with pytest.raises(RuntimeError, match="not found"):
        rt.radix_sort_unstable(x, device="cpu")
    assert not list(tmp_path.iterdir())


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "rdst_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host, "_SRC", bad)
    with pytest.raises(RuntimeError, match="rdst_host.cpp") as e:
        host.available()
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").rglob("*.so"))


# -- the builder's host path -----------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_path_matches_jax(dtype, rng, host_max, host_calls):
    """Keys, stable key-value pairs and stable argsort, bit-equal to the
    JAX package's host path: every NaN, both zeros and both infinities."""
    n = 30_000
    x = _keys(dtype, n, rng)
    x0 = x.copy()
    v = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    got = rt.radix_sort_unstable(x, device="cpu")
    want = jrt.radix_sort_unstable(x)
    assert isinstance(got, np.ndarray) and got.dtype == x.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    gk, gv = rt.sort_key_value(x, v, stable=True, device="cpu")
    wk, wv = jrt.sort_key_value(x, v, stable=True)
    np.testing.assert_array_equal(_bits(gk), _bits(wk))
    np.testing.assert_array_equal(gv, wv)
    gi = rt.argsort(x, device="cpu")
    np.testing.assert_array_equal(gi, jrt.argsort(x))
    assert gi.dtype == np.uint32
    np.testing.assert_array_equal(_bits(x), _bits(x0))  # input untouched
    assert host_calls == [n, n, n]


def test_host_fold_is_the_jax_fold():
    """The folded words of ±NaN (with payload bits), ±0 and ±Inf equal the
    JAX package's normalized word, and the unfold inverts them."""
    from rdst_tpu import keys as jkeys

    specials = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.5, -1.5]
    for dt in (np.float16, np.float32, np.float64):
        x = np.array(specials, dtype=dt)
        u = _bits(x).copy()
        u[4] |= 1  # a NaN with payload bits
        x = u.view(dt)
        folded = tbuilder._host_fold(x)
        words = [np.asarray(w).astype(np.uint64) for w in jkeys.normalize(x).words]
        want = words[0] if len(words) == 1 else (words[0] << np.uint64(32)) | words[1]
        np.testing.assert_array_equal(folded.astype(np.uint64), want)
        np.testing.assert_array_equal(_bits(tbuilder._host_unfold(folded, x.dtype)), u)


def test_host_path_payload_variants(rng, host_max, host_calls):
    n = 20_000
    k = rng.integers(0, 50, n).astype(np.uint32)
    order = np.argsort(k, kind="stable")
    v32 = rng.standard_normal(n).astype(np.float32)
    v16 = rng.integers(0, 2**16, n).astype(np.uint16)
    vb = rng.integers(0, 2, n).astype(bool)
    v8 = rng.integers(-128, 128, n).astype(np.int8)
    for pays in ([v32], [v32, v16], [v16], [vb, v8]):
        ks, got = rt.radix_sort_builder(k, pays, device="cpu").with_stable(True).sort()
        _, want = jrt.radix_sort_builder(k, pays).with_stable(True).sort()
        np.testing.assert_array_equal(ks, k[order])
        assert isinstance(got, tuple) and len(got) == len(pays)
        for g, w, p in zip(got, want, pays):
            assert g.dtype == p.dtype
            np.testing.assert_array_equal(g, p[order])
            np.testing.assert_array_equal(g, w)
    assert len(host_calls) == 4
    # an 8-byte payload is not the host path's: the device plans sort it
    v64 = rng.integers(0, 2**63, n, dtype=np.int64)
    ks, (g,) = rt.radix_sort_builder(k, [v64], device="cpu").with_stable(True).sort()
    np.testing.assert_array_equal(g, v64[order])
    assert len(host_calls) == 4


def test_host_path_not_taken_when_forced(rng, host_max, host_calls):
    """A forced Algorithm or a custom tuner runs the device plans."""
    x = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)

    class Custom(rt.StandardTuner):
        pass

    got = rt.radix_sort_builder(x, device="cpu").with_algorithm(
        rt.Algorithm.COMPARATIVE).sort()
    np.testing.assert_array_equal(got, np.sort(x))
    got = rt.radix_sort_builder(x, device="cpu").with_tuner(Custom()).sort()
    np.testing.assert_array_equal(got, np.sort(x))
    assert not host_calls
    for b in (rt.radix_sort_builder(x, device="cpu"),
              rt.radix_sort_builder(x, device="cpu").with_low_mem_tuner(),
              rt.radix_sort_builder(x, device="cpu").with_single_threaded_tuner()
              .with_parallel(False)):
        np.testing.assert_array_equal(b.sort(), np.sort(x))
    assert host_calls == [x.size] * 3


def test_host_path_needs_numpy_1d(rng, host_max, host_calls):
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    got = rt.radix_sort_unstable(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.sort(x))
    a, b = rt.radix_sort_unstable((x, x[::-1].copy()), device="cpu")
    order = np.lexsort((x[::-1], x))
    np.testing.assert_array_equal(a, x[order])
    assert not host_calls


def test_stable_argsort_takes_host_path(rng, monkeypatch, host_max):
    """The device path made unreachable: stable argsort of a small numpy
    single key still answers, through the host path."""
    def boom(*a, **k):
        raise AssertionError("device path taken for a small numpy argsort")

    monkeypatch.setattr(tbuilder.Sorter, "run", boom)
    for dtype in (np.uint32, np.int64, np.float64, np.uint8):
        x = rng.integers(0, 50, 4096).astype(dtype)
        got = rt.argsort(x, stable=True, device="cpu")
        np.testing.assert_array_equal(got, np.argsort(x, kind="stable"))


@pytest.mark.parametrize("limit", [1000, 4096])
def test_host_sort_max_is_inclusive(rng, monkeypatch, host_calls, limit):
    monkeypatch.setattr(config, "host_sort_max", limit)
    for n, takes in ((limit, True), (limit + 1, False)):
        before = len(host_calls)
        x = rng.integers(0, 2**64, n, dtype=np.uint64)
        np.testing.assert_array_equal(rt.radix_sort_unstable(x, device="cpu"), np.sort(x))
        idx = rt.argsort(x, device="cpu")
        np.testing.assert_array_equal(idx, np.argsort(x, kind="stable"))
        assert (len(host_calls) - before == 2) == takes
        assert (len(host_calls) == before) != takes


def test_zero_disables_host_path(rng, monkeypatch, host_calls):
    monkeypatch.setattr(config, "host_sort_max", 0)
    x = rng.integers(0, 2**32, 100, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(rt.radix_sort_unstable(x, device="cpu"), np.sort(x))
    np.testing.assert_array_equal(rt.argsort(x, device="cpu"), np.argsort(x, kind="stable"))
    assert not host_calls


def test_cuda_request_raises_below_host_sort_max(rng, host_max, host_calls):
    """device="cuda" without CUDA raises whatever the size: the host path
    is routing by size, not a way round the card the caller asked for."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the no-CUDA rule is not reachable")
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    for call in (lambda: rt.radix_sort_unstable(x),
                 lambda: rt.sort_key_value(x, x, stable=True),
                 lambda: rt.argsort(x)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not host_calls
