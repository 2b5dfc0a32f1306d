"""Key normalization of the PyTorch port against ``rdst_tpu.keys``.

The same numpy inputs go through ``rdst_tpu.keys.normalize`` and
``rdst_tpu_torch.keys.normalize`` (numpy and tensor input, on the CPU).
Every comparison is exact: words are bit patterns, and denormalized keys
are compared through their unsigned bit views (NaN payloads included).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdst_tpu.keys as jk
import rdst_tpu_torch as rt
from rdst_tpu_torch import keys as tk

torch.set_num_threads(1)

N = 1000


def _bits_view(a: np.ndarray) -> np.ndarray:
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _sample(dt: np.dtype, rng) -> np.ndarray:
    raw = rng.integers(0, 256, size=N * dt.itemsize, dtype=np.uint8)
    x = raw.view(dt).copy()
    if dt.kind == "f":
        specials = np.array(
            [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
             np.finfo(dt).tiny / 2, -np.finfo(dt).tiny / 2,
             np.finfo(dt).max, np.finfo(dt).min], dtype=dt)
    else:
        info = np.iinfo(dt)
        specials = np.array([info.min, info.max, 0, 1, info.max - 1], dtype=dt)
    x[: specials.size] = specials
    return x


def _words(nk) -> list[np.ndarray]:
    return [np.asarray(w) for w in nk.words]


def _port_words(nk) -> list[np.ndarray]:
    return [w.numpy() for w in nk.words]


@pytest.mark.parametrize("dt", jk.supported_dtypes(), ids=str)
def test_words_bit_equal_and_round_trip(dt):
    rng = np.random.default_rng(dt.itemsize * 31 + ord(dt.kind))
    x = _sample(dt, rng)
    want = jk.normalize(x)
    got_np = tk.normalize(x, device="cpu")
    got_t = tk.normalize(torch.from_numpy(x))
    assert got_np.n_bytes == got_t.n_bytes == want.n_bytes
    for a, b, c in zip(_words(want), _port_words(got_np), _port_words(got_t)):
        assert b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    back_np = tk.denormalize_host(got_np)
    assert back_np.dtype == dt
    np.testing.assert_array_equal(_bits_view(back_np), _bits_view(x))
    back_t = tk.denormalize(got_t).numpy()
    np.testing.assert_array_equal(_bits_view(back_t), _bits_view(x))


def test_bfloat16_words():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2**16, size=N, dtype=np.uint16)
    bits[:6] = [0x7FC0, 0xFFC0, 0x0000, 0x8000, 0x7F80, 0xFF80]  # NaN, 0, Inf
    want = jk.normalize(jax.lax.bitcast_convert_type(jnp.asarray(bits),
                                                     jnp.bfloat16))
    t = torch.from_numpy(bits).view(torch.bfloat16)
    got = tk.normalize(t)
    np.testing.assert_array_equal(_words(want)[0], _port_words(got)[0])
    back = tk.denormalize(got).view(torch.uint16).numpy()
    np.testing.assert_array_equal(back, bits)


def test_composite_words_and_fields():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**16, size=N).astype(np.uint16)
    b = _sample(np.dtype(np.float32), rng)
    c = rng.integers(-(2**63), 2**63, size=N, dtype=np.int64)
    want = jk.normalize((a, b, c))
    got = tk.normalize((a, b, c), device="cpu")
    assert got.n_bytes == want.n_bytes == 14
    for x, y in zip(_words(want), _port_words(got)):
        np.testing.assert_array_equal(x, y)
    fa, fb, fc = tk.denormalize_host(got)
    np.testing.assert_array_equal(fa, a)
    np.testing.assert_array_equal(_bits_view(fb), _bits_view(b))
    np.testing.assert_array_equal(fc, c)


@pytest.mark.parametrize("width", [1, 3, 4, 7, 9])
def test_byte_array_words(width):
    rng = np.random.default_rng(width)
    x = rng.integers(0, 256, size=(N, width), dtype=np.uint8)
    x[:4] = np.array([0, 255, 1, 128], dtype=np.uint8)[:, None]
    want = jk.normalize(x)
    got = tk.normalize(x, device="cpu")
    assert got.n_bytes == want.n_bytes == width
    for a, b in zip(_words(want), _port_words(got)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tk.denormalize_host(got), x)


def _laid_out(x: np.ndarray, layout: str) -> np.ndarray:
    """``x``'s values in another memory layout."""
    if layout == "swapped":
        return x.astype(x.dtype.newbyteorder("S"))
    if layout == "strided":
        wide = np.zeros(2 * x.size, x.dtype)
        wide[::2] = x
        return wide[::2]
    x = x.copy()
    x.flags.writeable = layout != "readonly"
    return x


def _total_order(x: np.ndarray) -> np.ndarray:
    """``x`` sorted by its normalized order: floats by the IEEE total
    order of their bits (-NaN first, +NaN last), integers by value."""
    if x.dtype.kind != "f":
        return np.sort(x)
    u = x.view(np.uint64)
    folded = np.where(u >> np.uint64(63) == 1, ~u, u | np.uint64(1 << 63))
    return x[np.argsort(folded, kind="stable")]


@pytest.mark.parametrize("layout", ["native", "swapped", "strided", "readonly"])
@pytest.mark.parametrize("dt", [np.uint64, np.int64, np.float64], ids=str)
def test_eight_byte_numpy_keys_fold_and_split_on_their_device(dt, layout):
    """u64, i64 (MIN and MAX among them) and f64 (+-0, +-Inf, NaNs of
    both signs) in every layout a caller may pass: the words are bit-equal
    to the JAX package's, the sort (5000 keys: past the host path) is in
    the normalized order, no warning is raised, and the caller's array is
    left as it was."""
    rng = np.random.default_rng(np.dtype(dt).itemsize * 97 + ord(np.dtype(dt).kind))
    native = np.concatenate([_sample(np.dtype(dt), rng) for _ in range(5)])
    x = _laid_out(native, layout)
    before = x.tobytes()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tk.normalize(x, device="cpu")
        out = rt.radix_sort_unstable(x, device="cpu")
    want = jk.normalize(native)
    assert got.n_bytes == want.n_bytes == 8
    assert got.meta == ("dtype", tk._torch_dtype(native.dtype))
    for a, b in zip(_words(want), _port_words(got)):
        np.testing.assert_array_equal(a, b)
    assert out.dtype == native.dtype
    np.testing.assert_array_equal(_bits_view(out), _bits_view(_total_order(native)))
    assert x.tobytes() == before
    assert x.flags.writeable == (layout != "readonly")


@pytest.mark.parametrize("writeable", [True, False])
@pytest.mark.parametrize("dt", [np.uint64, np.int64, np.float64], ids=str)
def test_contiguous_native_keys_upload_without_a_host_copy(dt, writeable, monkeypatch):
    """On the CPU the tensor that ``normalize`` folds and splits is the
    caller's array itself, read-only or not."""
    seen = []
    split = tk._normalize_tensor
    monkeypatch.setattr(tk, "_normalize_tensor", lambda t: seen.append(t) or split(t))
    x = _laid_out(_sample(np.dtype(dt), np.random.default_rng(3)),
                  "native" if writeable else "readonly")
    tk.normalize(x, device="cpu")
    (t,) = seen
    assert t.device.type == "cpu" and t.data_ptr() == x.ctypes.data
    assert t.numel() == x.size


@pytest.mark.parametrize("level,bits", [(0, 8), (3, 8), (5, 8), (0, 16), (6, 16)])
def test_digit_plane(level, bits):
    rng = np.random.default_rng(level + bits)
    words = rng.integers(0, 2**32, size=(2, N), dtype=np.uint32)
    want = np.asarray(jk.digit_plane([jnp.asarray(w) for w in words], level, bits))
    got = tk.digit_plane([torch.from_numpy(w) for w in words], level, bits)
    np.testing.assert_array_equal(want, got.numpy())


def test_from_numpy_carries_jax_keys_over():
    rng = np.random.default_rng(13)
    x = _sample(np.dtype(np.float64), rng)
    nk = jk.normalize(x)
    ported = tk.from_numpy(_words(nk), nk.n_bytes, nk.meta, device="cpu")
    assert ported.meta == ("dtype", torch.float64)
    np.testing.assert_array_equal(
        _bits_view(tk.denormalize_host(ported)), _bits_view(x))


def test_unsupported_and_shape_errors():
    with pytest.raises(TypeError):
        tk.normalize(np.zeros(4, dtype=bool), device="cpu")
    with pytest.raises(ValueError):
        tk.normalize(np.zeros((2, 2), dtype=np.uint32), device="cpu")
    with pytest.raises(ValueError):
        tk.digit_plane([torch.zeros(4, dtype=torch.uint32)], 3, 16)


def test_numpy_to_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the no-CUDA rule is not reachable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tk.normalize(np.arange(10, dtype=np.uint32))
