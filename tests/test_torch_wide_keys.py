"""128-bit, half-precision and wide byte-array keys: the port against the JAX
package (``tests/test_wide_keys.py``'s cases) on the same seeded input, and
against the same oracles.  numpy's bfloat16 (ml_dtypes', dtype kind "V")
goes in and comes back as itself, bit-equal to the JAX package's sort,
signed NaNs, zeros and infinities included."""
import ml_dtypes
import numpy as np
import pytest

import rdst_tpu as rt
import rdst_tpu_torch as tt
from rdst_tpu import keys as rkeys
from rdst_tpu_torch import keys as tkeys


def _words(nk):
    return [np.asarray(w).view(np.uint32) for w in nk.words]


def _same(jax_out, port_out):
    """Bit-equal arrays, or tuples of them, of the same dtypes."""
    if isinstance(jax_out, tuple):
        assert isinstance(port_out, tuple) and len(port_out) == len(jax_out)
        for a, b in zip(jax_out, port_out):
            _same(a, b)
        return
    a, b = np.asarray(jax_out), np.asarray(port_out)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("signed", [False, True], ids=["u128", "i128"])
def test_128_bit_composite_sort(signed):
    """u128 = (hi u64, lo u64), i128 = (hi i64, lo u64): 16 byte levels,
    the sign bias on the high half only (radix_key_impl.rs:123-130)."""
    rng = np.random.default_rng(128 + signed)
    n = 5_000
    if signed:
        hi = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    else:
        hi = rng.integers(0, 2**64, n, dtype=np.uint64)
    lo = rng.integers(0, 2**64, n, dtype=np.uint64)
    hi[:50] = hi[50:100]  # ties in the high half
    nk = tkeys.normalize((hi, lo), device="cpu")
    assert (nk.n_bytes, nk.n_words) == (16, 4)
    jn = rkeys.normalize((hi, lo))
    for a, b in zip(_words(jn), _words(nk)):
        np.testing.assert_array_equal(a, b)
    got = tt.radix_sort_unstable((hi, lo), device="cpu")
    _same(rt.radix_sort_unstable((hi, lo)), got)
    big = [(int(h) << 64) | int(w) for h, w in zip(hi, lo)]
    order = np.argsort(np.array(big, dtype=object), kind="stable")
    np.testing.assert_array_equal(got[0], hi[order])
    np.testing.assert_array_equal(got[1], lo[order])


_F16_SPECIALS = [0x7E00, 0xFE00, 0x7C00, 0xFC00, 0x0000, 0x8000, 0x7C01, 0xFFFF]
_BF16_SPECIALS = [0x7FC0, 0xFFC0, 0x7F80, 0xFF80, 0x0000, 0x8000, 0x7F81, 0xFFFF]


def _half_keys(dtype, seed, n=5_000):
    """Normal values with +-NaN (NaN payloads too), +-Inf and +-0 planted."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(dtype)
    specials = _BF16_SPECIALS if dtype == ml_dtypes.bfloat16 else _F16_SPECIALS
    x.view(np.uint16)[rng.choice(n, 8 * 20, replace=False)] = np.repeat(specials, 20)
    return x


@pytest.mark.parametrize("dtype", [np.float16, ml_dtypes.bfloat16],
                         ids=["float16", "bfloat16"])
def test_half_precision(dtype):
    x = _half_keys(dtype, 16)
    got = tt.radix_sort_unstable(x, device="cpu")
    assert got.dtype == x.dtype
    _same(rt.radix_sort_unstable(x), got)
    order = np.argsort(_words(rkeys.normalize(x))[0], kind="stable")
    np.testing.assert_array_equal(got.view(np.uint16), x[order].view(np.uint16))


@pytest.mark.parametrize("call", ["sort_key_value", "argsort", "composite", "builder"])
def test_numpy_bfloat16_through_each_entry(call):
    """numpy bfloat16 keys through every public numpy-in call come back as
    the JAX package returns them: keys of the caller's dtype, payloads and
    permutations bit-equal."""
    x = _half_keys(ml_dtypes.bfloat16, 17)
    n = x.size
    v = np.arange(n, dtype=np.uint32)
    if call == "sort_key_value":
        want = rt.sort_key_value(x, v, stable=True)
        got = tt.sort_key_value(x, v, stable=True, device="cpu")
    elif call == "argsort":
        want, got = rt.argsort(x), tt.argsort(x, device="cpu")
    elif call == "composite":
        a16 = np.random.default_rng(18).integers(0, 4, n).astype(np.uint16)
        want = rt.radix_sort_unstable((a16, x))
        got = tt.radix_sort_unstable((a16, x), device="cpu")
        assert got[1].dtype == x.dtype
    else:
        want = rt.radix_sort_builder(x, [v]).with_stable(True).sort()
        got = tt.radix_sort_builder(x, [v], device="cpu").with_stable(True).sort()
    _same(tuple(want) if isinstance(want, tuple) else want,
          tuple(got) if isinstance(got, tuple) else got)


def test_numpy_bfloat16_words_match():
    x = _half_keys(ml_dtypes.bfloat16, 19)
    nk = tkeys.normalize(x, device="cpu")
    assert nk.meta == ("dtype", tkeys._torch_dtype(x.dtype))
    np.testing.assert_array_equal(_words(rkeys.normalize(x))[0], _words(nk)[0])


def test_byte_array_16_wide():
    """[u8; 16] keys: the reference's widest fixed array pattern."""
    rng = np.random.default_rng(1616)
    x = rng.integers(0, 256, size=(1_000, 16), dtype=np.uint8)
    x[:100, :15] = x[100:200, :15]  # ties down to the last byte
    got = tt.radix_sort_unstable(x, device="cpu")
    _same(rt.radix_sort_unstable(x), got)
    assert list(map(tuple, got.tolist())) == sorted(map(tuple, x.tolist()))
