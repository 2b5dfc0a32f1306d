"""The port's row-batched sorts (rdst_tpu_torch.ops.rows) against the JAX
package's (rdst_tpu.ops.rows), one counterpart of every case in
``test_rows.py``, plus ``descending=True`` and ``byte_keys``.

Both get the same numpy input, made from a seed; the port runs on the CPU
(``device="cpu"``).  Tolerances: sorted keys are bit-equal (floats by their
bits, NaN-free as in the reference's test); stable payloads are bit-equal;
unstable and top-k payloads are compared as the (key, payload) pairs of
each row, since ties may come in another order (``torch.topk`` promises
none).
"""
import numpy as np
import pytest
import torch

import rdst_tpu as jr
import rdst_tpu_torch as rt

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    x = _np(x)
    return x.view(f"u{x.dtype.itemsize}") if x.dtype.kind == "f" else x


def _keys(dtype, shape, rng):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, endpoint=True, dtype=dtype)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize(
    "dtype", [np.uint32, np.int64, np.float32, np.float64, np.uint8, np.int16]
)
def test_batched_sort_matches_jax(dtype, descending):
    rng = np.random.default_rng(np.dtype(dtype).num)
    x = _keys(dtype, (33, 257), rng)
    got, pays = rt.batched_sort(x, descending=descending, device="cpu")
    want, _ = jr.batched_sort(x, descending=descending)
    assert pays == [] and got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref = np.sort(x, axis=-1)
    np.testing.assert_array_equal(_np(got), ref[..., ::-1] if descending else ref)


@pytest.mark.parametrize("descending", [False, True])
def test_batched_sort_payload_and_stability(descending):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 8, size=(16, 512), dtype=np.uint32)  # many ties
    payload = np.broadcast_to(np.arange(512, dtype=np.uint32), (16, 512)).copy()
    f = rng.standard_normal((16, 512)).astype(np.float32)
    got, (p, q) = rt.batched_sort(x, [payload, f], stable=True,
                                  descending=descending, device="cpu")
    want, (wp, wq) = jr.batched_sort(x, [payload, f], stable=True,
                                     descending=descending)
    for a, b in ((got, want), (p, wp), (q, wq)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    if not descending:
        order = np.argsort(x, axis=-1, kind="stable")
        np.testing.assert_array_equal(_np(p), np.take_along_axis(payload, order, -1))


def test_batched_sort_unstable_payload_pairs():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 8, size=(16, 300), dtype=np.uint32)
    pay = rng.integers(0, 2**32, size=(16, 300), dtype=np.uint32)
    got, (p,) = rt.batched_sort(x, [pay], device="cpu")
    want, (wp,) = jr.batched_sort(x, [pay])
    np.testing.assert_array_equal(_np(got), _np(want))
    for r in range(x.shape[0]):
        assert sorted(zip(_np(got)[r].tolist(), _np(p)[r].tolist())) == \
            sorted(zip(_np(want)[r].tolist(), _np(wp)[r].tolist()))


def test_batched_sort_composite_key():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, size=(7, 128), dtype=np.uint16)
    b = rng.standard_normal((7, 128)).astype(np.float32)
    (sa, sb), _ = rt.batched_sort((a, b), device="cpu")
    (wa, wb), _ = jr.batched_sort((a, b))
    np.testing.assert_array_equal(_np(sa), _np(wa))
    np.testing.assert_array_equal(_bits(sb), _bits(wb))


@pytest.mark.parametrize("byte_keys", [None, True, False])
def test_byte_keys(byte_keys):
    """uint8 of 3 dimensions: byte-array keys unless ``byte_keys=False``;
    of 2 dimensions: scalar keys unless ``byte_keys=True``."""
    rng = np.random.default_rng(4)
    for shape in ((5, 40, 6), (9, 70)):
        x = rng.integers(0, 4, size=shape, dtype=np.uint8)  # ties in every byte
        v = rng.integers(0, 2**32, size=shape[:-1] if (
            byte_keys or (byte_keys is None and len(shape) == 3)) else shape,
            dtype=np.uint32)
        got, (p,) = rt.batched_sort(x, [v], stable=True, byte_keys=byte_keys,
                                    device="cpu")
        want, (wp,) = jr.batched_sort(x, [v], stable=True, byte_keys=byte_keys)
        assert got.shape == x.shape
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(p), _np(wp))
        top, (tp,) = rt.batched_top_k(x, 3, [v], byte_keys=byte_keys, device="cpu")
        wtop, _ = jr.batched_top_k(x, 3, [v], byte_keys=byte_keys)
        np.testing.assert_array_equal(_np(top), _np(wtop))
    with pytest.raises(TypeError, match="byte_keys=True requires"):
        rt.batched_sort(np.zeros((2, 3), np.uint16), byte_keys=True, device="cpu")


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32, np.uint16])
def test_batched_top_k_single_word(dtype, largest):
    rng = np.random.default_rng(5 + largest)
    x = _keys(dtype, (9, 300), rng)
    x[:, :40] = x[:, 40:80]  # ties across the cut
    payload = rng.integers(0, 2**32, size=(9, 300)).astype(np.uint32)
    k = 17
    got, (p,) = rt.batched_top_k(x, k, [payload], largest=largest, device="cpu")
    want, (wp,) = jr.batched_top_k(x, k, [payload], largest=largest)
    assert got.shape == p.shape == (9, k)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for r in range(x.shape[0]):
        pairs = set(zip(_bits(x)[r].tolist(), payload[r].tolist()))
        got_pairs = list(zip(_bits(got)[r].tolist(), _np(p)[r].tolist()))
        assert set(got_pairs) <= pairs, f"row {r}: payload mispaired"
        assert len(set(got_pairs)) == k


@pytest.mark.parametrize("largest", [True, False])
def test_batched_top_k_wide_key_fallback(largest):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**64, size=(5, 200), dtype=np.uint64)
    v = rng.standard_normal((5, 200)).astype(np.float32)
    got, (p,) = rt.batched_top_k(x, 9, [v], largest=largest, device="cpu")
    want, (wp,) = jr.batched_top_k(x, 9, [v], largest=largest)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_bits(p), _bits(wp))  # distinct keys


def test_batched_top_k_k_bounds():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 100, size=(3, 32), dtype=np.uint32)
    for bad in (0, 33):
        with pytest.raises(ValueError, match="out of range"):
            rt.batched_top_k(x, bad, device="cpu")
        with pytest.raises(ValueError, match="out of range"):
            jr.batched_top_k(x, bad)
    got, _ = rt.batched_top_k(x, 32, device="cpu")
    assert got.shape == (3, 32)


def test_tensor_input_stays_on_its_device():
    """The counterpart of the reference's ``jit`` case: tensors in, tensors
    out on their own device; numpy needs ``device`` (``"cuda"`` by
    default)."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**32, size=(8, 256), dtype=np.uint32)
    got, _ = rt.batched_sort(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=-1))
    top, _ = rt.batched_top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(top.numpy(), np.sort(x, axis=-1)[:, ::-1][:, :4])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rt.batched_sort(x)
